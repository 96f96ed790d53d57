"""The energy reader's parsing and integration; the card's counter itself is
read only on the card."""
import pytest

from perfbench import energy


def test_pci_bus_id_is_nvmls_form():
    assert energy.pci_bus_id(0, 0x1B, 0) == "00000000:1b:00.0"


@pytest.mark.parametrize("line,watts", [("312.45\n", 312.45), ("71.00, 700.00", 71.0),
                                        ("[N/A]", None), ("", None)])
def test_parse_smi_power(line, watts):
    assert energy.parse_smi_power(line) == watts


def test_integrate_trapezoids_and_holds_the_ends():
    samples = [(1.0, 100.0), (2.0, 300.0), (3.0, 300.0)]
    assert energy.integrate(samples, 1.0, 3.0) == pytest.approx(200.0 + 300.0)
    # before the first sample and after the last the power is held flat
    assert energy.integrate(samples, 0.0, 4.0) == pytest.approx(100.0 + 500.0 + 300.0)
    # a window between samples takes the interpolation's ends as flat holds
    assert energy.integrate(samples, 1.5, 2.5) > 0
    assert energy.integrate([], 0.0, 1.0) == 0.0
