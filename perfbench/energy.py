"""The card's own energy, read by the benchmark: NVML's cumulative counter
(``nvmlDeviceGetTotalEnergyConsumption``, millijoules since the driver
loaded) through ``ctypes`` on the driver's ``libnvidia-ml.so.1``, the card
matched by its UUID or PCI bus id, never by index.  Only where the counter
is unsupported, ``nvidia-smi`` samples ``power.draw`` every 50 ms and the
samples are integrated.  With neither there is no reading: the run fails,
and no modelled watt ever stands in.
"""
from __future__ import annotations

import ctypes
import subprocess
import threading
import time
from typing import List, Optional, Tuple

_NVML_OK = 0


def pci_bus_id(domain: int, bus: int, device: int) -> str:
    """NVML's form of a PCI bus id: ``0000:1b:00.0``."""
    return f"{domain:08x}:{bus:02x}:{device:02x}.0"


def parse_smi_power(line: str) -> Optional[float]:
    """Watts from one ``nvidia-smi --query-gpu=power.draw
    --format=csv,noheader,nounits`` line; None for ``[N/A]`` or junk."""
    try:
        return float(line.strip().split(",")[0])
    except ValueError:
        return None


def integrate(samples: List[Tuple[float, float]], t0: float, t1: float) -> float:
    """Joules between ``t0`` and ``t1`` from ``(time, watts)`` samples in
    time order: trapezoids between samples, each end held flat."""
    pts = [(t, w) for t, w in samples if t0 <= t <= t1]
    before = [s for s in samples if s[0] < t0]
    after = [s for s in samples if s[0] > t1]
    if before:
        pts.insert(0, (t0, before[-1][1]))
    if after:
        pts.append((t1, after[0][1]))
    if not pts:
        return 0.0
    if pts[0][0] > t0:
        pts.insert(0, (t0, pts[0][1]))
    if pts[-1][0] < t1:
        pts.append((t1, pts[-1][1]))
    return sum((b[0] - a[0]) * (a[1] + b[1]) / 2 for a, b in zip(pts, pts[1:]))


def device_ids(index: int) -> Tuple[Optional[str], Optional[str]]:
    """(UUID as NVML writes it, PCI bus id) of torch's CUDA device ``index``."""
    import torch

    props = torch.cuda.get_device_properties(index)
    uuid = getattr(props, "uuid", None)
    uuid = None if uuid is None else "GPU-" + str(uuid)
    pci = None
    if hasattr(props, "pci_bus_id"):
        pci = pci_bus_id(getattr(props, "pci_domain_id", 0), props.pci_bus_id,
                         getattr(props, "pci_device_id", 0))
    return uuid, pci


class _Nvml:
    def __init__(self, uuid: Optional[str], pci: Optional[str]):
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        handle_p = ctypes.POINTER(ctypes.c_void_p)
        for name, args in (("nvmlInit_v2", []), ("nvmlShutdown", []),
                           ("nvmlDeviceGetHandleByUUID", [ctypes.c_char_p, handle_p]),
                           ("nvmlDeviceGetHandleByPciBusId_v2", [ctypes.c_char_p, handle_p]),
                           ("nvmlDeviceGetTotalEnergyConsumption",
                            [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
                           ("nvmlDeviceGetEnforcedPowerLimit",
                            [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        if lib.nvmlInit_v2() != _NVML_OK:
            raise OSError("nvmlInit_v2 failed")
        self.lib = lib
        self.handle = ctypes.c_void_p()
        rc = -1
        if uuid:
            rc = lib.nvmlDeviceGetHandleByUUID(uuid.encode(), ctypes.byref(self.handle))
        if rc != _NVML_OK and pci:
            rc = lib.nvmlDeviceGetHandleByPciBusId_v2(pci.encode(), ctypes.byref(self.handle))
        if rc != _NVML_OK:
            raise OSError(f"NVML found no device {uuid or pci}")
        self.millijoules()                         # raises where unsupported

    def millijoules(self) -> int:
        v = ctypes.c_ulonglong()
        rc = self.lib.nvmlDeviceGetTotalEnergyConsumption(self.handle, ctypes.byref(v))
        if rc != _NVML_OK:
            raise OSError(f"nvmlDeviceGetTotalEnergyConsumption returned {rc}")
        return int(v.value)

    def power_limit_w(self) -> Optional[float]:
        v = ctypes.c_uint()
        ok = self.lib.nvmlDeviceGetEnforcedPowerLimit(self.handle, ctypes.byref(v)) == _NVML_OK
        return v.value / 1000.0 if ok else None

    def close(self) -> None:
        self.lib.nvmlShutdown()


class _SmiPower:
    """``nvidia-smi`` sampling power.draw every 50 ms in a child process."""

    def __init__(self, device: str):
        self.samples: List[Tuple[float, float]] = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=power.draw", "--format=csv,noheader,nounits",
             "-i", device, "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        deadline = time.monotonic() + 5
        while not self.samples and time.monotonic() < deadline:
            time.sleep(0.05)
        if not self.samples:
            self.close()
            raise OSError("nvidia-smi gave no power.draw sample")

    def _read(self) -> None:
        for line in self.proc.stdout:
            w = parse_smi_power(line)
            if w is not None:
                self.samples.append((time.monotonic(), w))

    def close(self) -> None:
        self.proc.terminate()
        self.proc.wait(timeout=10)
        self.thread.join(timeout=10)


class Energy:
    """``read()`` -> (monotonic seconds, cumulative joules) of one card;
    ``source`` names where the joules come from."""

    def __init__(self, index: int = 0):
        uuid, pci = device_ids(index)
        self.device = uuid or pci
        self._nvml = self._smi = None
        try:
            self._nvml = _Nvml(uuid, pci)
            self.source = f"NVML nvmlDeviceGetTotalEnergyConsumption ({self.device})"
        except (OSError, AttributeError) as err:
            self._smi = _SmiPower(pci or uuid)
            self.source = (f"nvidia-smi power.draw every 50 ms, integrated ({self.device}; "
                           f"NVML counter unavailable: {err})")
        self._t0 = time.monotonic()

    def read(self) -> Tuple[float, float]:
        if self._nvml is not None:
            return time.monotonic(), self._nvml.millijoules() / 1000.0
        t = time.monotonic()
        return t, integrate(list(self._smi.samples), self._t0, t)

    def power_limit_w(self) -> Optional[float]:
        if self._nvml is not None:
            return self._nvml.power_limit_w()
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", self.device],
                             capture_output=True, text=True, timeout=30).stdout
        return parse_smi_power(out)

    def close(self) -> None:
        if self._nvml is not None:
            self._nvml.close()
        if self._smi is not None:
            self._smi.close()
