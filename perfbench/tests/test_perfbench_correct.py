"""``correct`` at a small size on the CPU, through the kernels' plain
versions: true for the program as it is; false for the control (the plain
reference computed in bfloat16 in the program's place) and for each fault
a cell can have, planted under the timed path: a step that leaves its state
unchanged, half of the paths left out with the mean taken over the rest,
and an answer altered where it is produced. No cell spans chips, so none
can leave out an exchange between them. The limits are the cells' own.
And a run whose reference loads a module of JAX gives no result."""

import sys
import time
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from perfbench import check, run  # noqa: E402

sys.path.remove(str(ROOT))

SMALL = {"put-1M.mega": {"n_paths": 131072, "n_steps": 16},
         "put-1M.fusedpath": {"n_paths": 131072, "n_steps": 16},
         "maxcall-5-1M.mega": {"n_paths": 8192}}
SEED = 2 ** 31 + 4321


def _manifest():
    return run.load_manifest(ROOT)


def _run(name):
    cell = run.Cell(_manifest(), name, SMALL[name])
    result, _ = run.run_cell(cell, SEED, 0.2, False, "cpu", time.monotonic())
    return result


@pytest.mark.parametrize("name", sorted(SMALL))
def test_program_is_correct(name):
    result = _run(name)
    assert result["failed"] == 0
    assert result["correct"], result["check"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(name):
    cell = run.Cell(_manifest(), name, SMALL[name])
    route = cell.route.Route(cell.config, torch.device("cpu"))
    readings = [route.judge(s, route.control(s)) for s in (SEED, SEED + 1)]
    correct, numbers = check.judge(readings, cell.limits)
    assert not correct, numbers


def _faulted_sums(out, fault):
    """The plain induction's results with its (2,) sums as the fault leaves them:
    doubled over half the paths (the mean over the rest), or the price altered."""
    out = list(out)
    if fault == "half":
        out[0] = 2 * out[0]
    if fault == "altered":
        out[0] = out[0] * torch.tensor([1.01, 1.0])
    return tuple(out)


def _mega(fault):
    from amcx_torch.ops import lsmc_megakernel as mod

    orig = mod._mega_reference

    def run_(paths, stats, K, phi, rcond, basis, degree, american, itm_weights, cf_tau=False):
        if fault == "unchanged":
            american = False
        if fault == "half":
            paths = paths[:, :paths.shape[1] // 2].contiguous()
        return _faulted_sums(orig(paths, stats, K, phi, rcond, basis, degree, american,
                                  itm_weights, cf_tau), fault)
    return mod, "_mega_reference", run_


def _fusedpath(fault):
    from amcx_torch.ops import lsmc_fusedpath as mod

    orig = mod._fusedpath_reference

    def run_(cfg, stats, coeffs, allow, cf_tau, normals=None):
        if fault == "unchanged":
            cfg = cfg._replace(american=False)
        if fault == "half":
            cfg = cfg._replace(n_paths=cfg.n_paths // 2)
        return _faulted_sums(orig(cfg, stats, coeffs, allow, cf_tau, normals), fault)
    return mod, "_fusedpath_reference", run_


def _maxcall(fault):
    from amcx_torch.ops import lsmc_ma_mega as mod

    orig = mod._ma_mega_reference

    def run_(planes, stats, cfg, cf_tau, antithetic):
        if fault == "unchanged":
            stats = stats.clone()
            stats[-1] = 0.0  # the exercise row: no date may exercise
        if fault == "half":
            planes = planes[:, :, :planes.shape[2] // 2].contiguous()
        return _faulted_sums(orig(planes, stats, cfg, cf_tau, antithetic), fault)
    return mod, "_ma_mega_reference", run_


FAULTS = {"put-1M.mega": _mega, "put-1M.fusedpath": _fusedpath,
          "maxcall-5-1M.mega": _maxcall}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_fault_is_not_correct(name, fault, monkeypatch):
    mod, attr, broken = FAULTS[name](fault)
    monkeypatch.setattr(mod, attr, broken)
    result = _run(name)
    assert not result["correct"], result["check"]


def test_a_jax_module_loaded_by_the_reference_stops_the_result(monkeypatch):
    name = "put-1M.mega"
    cell = run.Cell(_manifest(), name, SMALL[name])
    judge = cell.route.Route.judge

    def judge_loading_jax(self, seed, prog):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return judge(self, seed, prog)
    monkeypatch.setattr(cell.route.Route, "judge", judge_loading_jax)
    with pytest.raises(RuntimeError, match="jax"):
        run.run_cell(cell, SEED, 0.2, False, "cpu", time.monotonic())
