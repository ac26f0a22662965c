"""CPU rehearsals of every cell, and of the mixes kept for later (PERF.md's
Open questions), whose files stay so that they return by data alone: the
whole run at a tiny batch, its last line, the import guard, the run without
a card, the control and the faults that the comparison must catch."""

import json
import os
import subprocess
import sys

import pytest
import torch

from qpbench import run
from qpbench.workload import ROOT, Engine

BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
#: the per-lane mix, out of BENCHMARK.json while the per-lane engine leaves
#: lanes unsolved that the reference solves
LATER = [{"name": "control-perlane", "config": "control-fleet-nx8-T10",
          "traffic": "control-perlane", "chips": 1, "why": "later"}]
LATER_CONFIGS = [{"name": "control-fleet-nx8-T10", "reduced": [],
                  "file": "qpbench/configs/control-fleet-nx8-T10.json"}]
CELLS = [w["name"] for w in BENCH["workloads"] + LATER]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(autouse=True)
def _later_cells(tmp_path, monkeypatch):
    """Runs see BENCHMARK.json with the mixes kept for later added."""
    bench = dict(BENCH, workloads=BENCH["workloads"] + LATER,
                 configs=BENCH["configs"] + LATER_CONFIGS)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    load = run.load_cell
    monkeypatch.setattr(run, "load_cell",
                        lambda name, bench_path=None: load(name, path))


def _rehearse(capsys, cell, *extra, seed=2 ** 31 + 7, trace=0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", str(trace), "--rehearse", "--batch",
                   "8", *extra])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    line = json.loads(out[-1])
    assert set(line) >= KEYS and list(line)[-1] == "checks"
    assert line["metrics"] == {}                 # no device metric
    assert line["device"]["platform"] == "cpu"
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal_is_correct(capsys, cell):
    line = _rehearse(capsys, cell)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 8


def test_traced_rehearsal(capsys):
    line = _rehearse(capsys, CELLS[0], trace=1)
    assert line["correct"] is True
    assert "breakdown" not in line               # no device trace on a CPU


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(capsys, cell):
    line = _rehearse(capsys, cell, "--control")
    assert line["correct"] is False
    checks = line["checks"]
    assert (checks["status_mismatch"]["value"] > 0
            or checks["claim_gap"]["value"] > checks["claim_gap"]["limit"])


def _unchanged(b, out):
    x = b.x0 if b.x0 is not None else torch.zeros_like(out.x)
    y = b.y0 if b.y0 is not None else torch.zeros_like(out.y)
    return out._replace(x=x, y=y, z=torch.zeros_like(out.z))


def _half(b, out):
    h = out.x.shape[0] // 2
    keep = torch.arange(out.x.shape[0]) < h
    k = keep[:, None].to(out.x.device)
    return out._replace(x=torch.where(k, out.x, 0.0),
                        y=torch.where(k, out.y, 0.0),
                        z=torch.where(k, out.z, 0.0))


def _altered(b, out):
    return out._replace(x=out.x + torch.nn.functional.pad(
        torch.full_like(out.x[:, :1], 0.05), (0, out.x.shape[1] - 1)))


def _one_unsolved(b, out):
    status = out.status.clone()
    status[-1] = -2                           # max_iter reached
    return out._replace(status=status)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered,
                                   _one_unsolved],
                         ids=["state_unchanged", "half_batch", "altered",
                              "one_unsolved"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(capsys, monkeypatch, cell, fault):
    call = Engine.call

    def broken(self, b):
        return fault(b, call(self, b))

    monkeypatch.setattr(Engine, "call", broken)
    line = _rehearse(capsys, cell)
    assert line["correct"] is False, line["checks"]


def test_unsolved_lanes_get_a_second_look(capsys, monkeypatch):
    """A lane the window did not end Solved is solved again by the
    reference, and the run's earlier line says what both found."""
    call = Engine.call
    monkeypatch.setattr(Engine, "call",
                        lambda self, b: _one_unsolved(b, call(self, b)))
    rc = run.main(["--workload", "control-cold", "--seed", "11",
                   "--seconds", "0.2", "--trace", "0", "--rehearse",
                   "--batch", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and json.loads(out[-1])["correct"] is False
    info = json.loads(next(ln for ln in out
                           if ln.startswith("[qpbench] {"))[10:])
    looks = info["unsolved_lanes"]
    assert 1 <= len(looks) <= run.UNSOLVED_KEPT
    assert all(st == -2 and ref == 1 for st, _, ref, _ in looks)


def test_import_guard_compares_whole_names():
    assert run.forbidden_loaded({"osqp_tpu_torch": 1,
                                 "osqp_tpu_torch.batch": 1,
                                 "jaxtyping": 1, "osqp_tpu_x": 1}) == []
    assert run.forbidden_loaded({"osqp_tpu.batch": 1, "jax.numpy": 1,
                                 "jaxlib": 1, "flax.linen": 1}) == [
        "flax", "jax", "jaxlib", "osqp_tpu"]


def test_a_run_loads_no_jax(capsys):
    _rehearse(capsys, CELLS[0])
    mods = {m.split(".")[0] for m in sys.modules}
    if "jax" in mods:
        pytest.skip("another test of this process loaded jax")
    assert run.forbidden_loaded() == []


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "qpbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT.parent, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
    assert "CUDA" in r.stderr


@pytest.mark.cuda
def test_cell_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rc = run.main(["--workload", CELLS[0], "--seed", "5", "--seconds", "2",
                   "--trace", "0"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) >= {"qp_per_s", "batch_p95_ms", "setup_s"}
