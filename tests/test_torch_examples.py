"""The port's public surfaces and its five examples, on the CPU.

* The export tables: ``repro_torch.serve``, ``repro_torch.models``,
  ``repro_torch.dist`` and ``repro_torch.launch`` name what the
  reference's do, where the port has the module, with the reference's
  lazy resolution and ``dir()``; ``transformer.param_count`` equals the
  reference's on the bridged tree.
* ``examples/torch_*.py``, each run once with ``--device cpu`` at its small
  preset and a few steps, through the port's public imports.
"""
import importlib
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import repro.dist as JD
import repro.launch as JLA
import repro.models as JM
import repro.serve as JS
import repro_torch.dist as TD
import repro_torch.launch as TLA
import repro_torch.models as TM
import repro_torch.serve as TS
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.models import transformer as TT
from repro_torch.train.loop import init_state
from repro_torch.train.optimizer import OptConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
# the reference's serve exports the port does not have yet, and what each waits for
SERVE_WAITING = {}


# --------------------------------------------------------------------------
# the export tables
# --------------------------------------------------------------------------

def test_serve_exports_the_reference_names_the_port_has():
    assert set(JS._EXPORTS) - set(TS._EXPORTS) == set(SERVE_WAITING)
    assert len(TS._EXPORTS) == 24 and TS.__all__ == sorted(TS._EXPORTS)
    for name, module in TS._EXPORTS.items():
        assert module == JS._EXPORTS[name].replace("repro.", "repro_torch.", 1)
        assert getattr(TS, name) is getattr(importlib.import_module(module), name)
    from repro_torch.serve import ContinuousEngine, PrefixCache, SLOTracker  # noqa: F401

    assert TS._SUBMODULES == JS._SUBMODULES
    listing = dir(TS)
    for name in list(TS._EXPORTS) + list(TS._SUBMODULES):
        assert name in listing, name
    assert TS.fleet.PrefixCache is TS.PrefixCache and TS.fleet.FleetSim is TS.FleetSim
    for name in ("not_a_symbol", *SERVE_WAITING):
        with pytest.raises(AttributeError):
            getattr(TS, name)


def test_models_export_the_reference_names():
    assert TM.__all__ == JM.__all__
    for name in JM.__all__:
        assert getattr(TM, name) is getattr(TT, name)
    from repro_torch.models import decode_step, init_params  # noqa: F401

    assert set(TM.__all__) <= set(dir(TM))
    with pytest.raises(AttributeError):
        TM.not_a_symbol


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b", "granite-moe-3b-a800m",
                                  "mamba2-130m"])
def test_param_count_equals_the_reference(arch):
    jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    assert TT.param_count(tp) == JT.param_count(jp) > 0


def test_dist_and_launch_export_what_the_port_has():
    for name in ("CheckpointManager", "ElasticMesh", "FailureInjector", "StragglerDetector",
                 "compressed_psum"):
        assert getattr(JD, name).__module__.replace("repro.", "repro_torch.", 1) == \
            getattr(TD, name).__module__, name
    assert set(JLA._SUBMODULES) - set(TLA._SUBMODULES) == set()
    assert {"dryrun", "mesh", "serve", "train"} <= set(TLA.__all__) <= set(dir(TLA))
    assert TLA.train.__name__ == "repro_torch.launch.train"
    assert TLA.mesh.__name__ == "repro_torch.launch.mesh"
    assert TLA.dryrun.__name__ == "repro_torch.launch.dryrun"
    assert TD.sharding.__name__ == "repro_torch.dist.sharding"
    with pytest.raises(AttributeError):
        TLA.not_a_module


# --------------------------------------------------------------------------
# the examples
# --------------------------------------------------------------------------

def example(name):
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_and_simulates(capsys):
    losses = example("quickstart").main(["--device", "cpu", "--steps", "12"])
    assert len(losses) == 12 and np.isfinite(losses).all() and losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "cntd_slack" in out and "energy saving" in out


def test_train_lm_saves_async_and_the_loss_falls(tmp_path):
    """The small preset, 100 steps of batch 2 x 16: the async checkpoint at
    step 100 is in the reference's layout, so the reference's manager
    restores it into the reference's training state and the port's through
    the bridge, and the mean of the last ten losses is at least 0.25 below
    that of the first ten."""
    losses = example("train_lm").main(["--device", "cpu", "--steps", "100", "--batch", "2",
                                       "--seq", "16", "--checkpoint-dir", str(tmp_path)])
    assert np.mean(losses[:10]) - np.mean(losses[-10:]) >= 0.25
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [100]
    cfg = reduced(get_config("countdown-100m"), n_layers=4, d_model=256, n_heads=8,
                  n_kv_heads=4, d_ff=1024, vocab=4096)
    skel = init_state(cfg, OptConfig(), torch.Generator().manual_seed(1), "cpu")
    tree = mgr.load(100, bridge.state_to_numpy(cfg, skel))
    state = bridge.state_from_numpy(cfg, tree, "cpu")
    assert int(state["opt"]["step"]) == 100

    from repro.dist.checkpoint import CheckpointManager as JCheckpointManager
    from repro.train.loop import init_state as jinit_state
    from repro.train.optimizer import OptConfig as JOptConfig

    jcfg = jreduced(jget_config("countdown-100m"), n_layers=4, d_model=256, n_heads=8,
                    n_kv_heads=4, d_ff=1024, vocab=4096)
    jstate = JCheckpointManager(str(tmp_path)).load(
        100, jinit_state(jcfg, JOptConfig(), jax.random.PRNGKey(1)))
    for got, want in zip(jax.tree.leaves(jstate), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(got), want)


def test_serve_decode_generates_and_serves():
    res = example("serve_decode").main(["--device", "cpu", "--steps", "4"])
    assert set(res["batched"]) == {"llama3.2-1b", "mixtral-8x22b", "mamba2-130m",
                                   "recurrentgemma-2b"}
    for arch, out in res["batched"].items():
        assert tuple(out.shape) == (4, 4)
        assert 0 <= int(out.min()) and int(out.max()) < reduced(get_config(arch)).vocab
    cont = res["continuous"]
    assert cont["requests"] == 8 and cont["tokens"] > 0 and cont["report"].n_calls > 0


def test_cluster_budget_arbiter_wins():
    res = example("cluster_budget").main(["--device", "cpu"])
    assert res["saving_pct"] > 0.0 and res["overhead_pct"] <= 1.0


def test_energy_aware_training_books_two_calls_a_step():
    import torch.distributed as dist

    res = example("energy_aware_training").main(["--device", "cpu", "--steps", "3"])
    assert res["world"] == 1 and len(res["losses"]) == 3
    assert np.isfinite(res["losses"]).all()
    assert res["report"].n_calls == 6                 # gradients and loss, each a step
    assert not dist.is_initialized()


def test_examples_mirror_the_originals():
    """Every original example has its port beside it, and each port takes
    ``--device``."""
    originals = sorted(n for n in os.listdir(os.path.join(ROOT, "examples"))
                       if n.endswith(".py") and not n.startswith("torch_"))
    for name in originals:
        text = open(os.path.join(ROOT, "examples", "torch_" + name)).read()
        assert '"--device"' in text, name
    assert len(originals) == 5
