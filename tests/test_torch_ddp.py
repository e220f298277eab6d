"""DDP on the CPU: two gloo processes, each on half of every global batch,
against one process on the whole batch (`tests/torch_ddp_worker.py`: the
SSOD trainer at width 0.125, nc 2, 64 px, float32, LabelMatch on; a
burn-in step, then 2 SSOD steps, each SSOD epoch ending in a LabelMatch
refresh). Torchrun's environment is given by hand (a free port on
127.0.0.1). The card holds the world-size-1 group (chip_smoke.py
`[ddp]`); NCCL refuses two ranks on one card.

Held: the loss parts of the first step (summed over the ranks) within
1e-6 of the largest part, of the later steps within 5e-5; the weights,
the EMA, the teacher (semi-EMA) and the BatchNorm statistics within 2e-4
of each tensor's largest entry (at least 1); LabelMatch's thresholds
within 1e-5; the two ranks bit-equal to each other; the update counts
exact; and only rank 0 created or wrote files under the run's project
directory. The first step agrees to float32 rounding (measured 4e-7);
the later ones part as float32 noise grows through this small random
net's updates: measured 1.6e-5 in the third step's loss, 6.5e-5 in a
running variance, 3.3e-6 in a threshold, of which a one-process run with
the synchronised BatchNorm's own two-pass arithmetic still shows 2.6e-6
and 3.3e-5 (batch 4 against batch 8 convolutions). A wrong loss scale,
count or gradient sum shows at the first step, at O(1).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_ddp_worker.py"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out, project, rank=None, world=2, port=None):
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    if rank is not None:
        env.update(RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
    return subprocess.Popen([sys.executable, str(WORKER), str(out),
                             str(project)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    (root / "two").mkdir()
    (root / "one").mkdir()
    port = _free_port()
    procs = [_launch(root / "two", root / "two_runs", r, 2, port)
             for r in range(2)]
    procs.append(_launch(root / "one", root / "one_runs"))
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out[-4000:]
    load = lambda p: torch.load(p, weights_only=False)  # noqa: E731
    return (load(root / "two" / "rank0.pt"), load(root / "two" / "rank1.pt"),
            load(root / "one" / "rank0.pt"))


def _close(a, b, tol, what):
    for k, v in b.items():
        if not v.is_floating_point():
            continue
        atol = tol * max(1.0, float(v.abs().max()))
        torch.testing.assert_close(a[k], v, rtol=0, atol=atol,
                                   msg=f"{what} {k}")


@pytest.mark.timeout(300)
def test_two_ranks_equal_one_process_on_the_global_batch(runs):
    r0, r1, one = runs
    assert (r0["world"], r1["world"], one["world"]) == (2, 2, 1)
    assert r0["updates"] == r1["updates"] == one["updates"] == (3, 2, 3)
    assert len(one["losses"]) == 3
    for i, (got, want) in enumerate(zip(r0["losses"], one["losses"])):
        assert set(got) == set(want)
        scale = max(abs(v) for v in want.values())
        tol = 1e-6 if i == 0 else 5e-5
        for k in want:
            assert abs(got[k] - want[k]) <= tol * scale, (i, k, got, want)
    assert any(v > 0 for v in one["losses"][-1].values()
               if not isinstance(v, bool))
    for what in ("model", "ema", "teacher"):
        _close(r0[what], one[what], 2e-4, what)
    for (h, lo), (wh, wlo) in zip(r0["thr"], one["thr"]):
        torch.testing.assert_close(torch.from_numpy(h), torch.from_numpy(wh),
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(torch.from_numpy(lo),
                                   torch.from_numpy(wlo), rtol=0, atol=1e-5)


@pytest.mark.timeout(300)
def test_ranks_agree_and_rank0_alone_writes(runs):
    r0, r1, one = runs
    for what in ("model", "ema", "teacher"):
        for k, v in r0[what].items():
            assert torch.equal(v, r1[what][k]), (what, k)
    assert r0["losses"] == r1["losses"]
    for (h0, l0), (h1, l1) in zip(r0["thr"], r1["thr"]):
        assert (h0 == h1).all() and (l0 == l1).all()
    # the refreshes moved the thresholds
    assert (r0["thr"][-1][0] != r0["thr"][0][0]).all()
    assert r1["written"] == []
    names = {Path(w).name for w in r0["written"]}
    assert {"opt.yaml", "results.csv", "last.ckpt", "best.ckpt"} <= \
        {n.replace(".tmp", "") for n in names}
    rel = lambda ws: {str(Path(w).relative_to(Path(ws[0]))) for w in ws}  # noqa
    assert rel(one["written"]) == rel(r0["written"])
