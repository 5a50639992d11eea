"""The rest of a run, without the look for a card, with the timed path
broken underneath: ``correct`` has to come out false for each fault the
cells can have.  (The cells run on one card, so there is no exchange
between chips to leave out.)  On the CPU at a test's size: one month,
two price scenarios a pass, two cases a fan-out."""
import json

import numpy as np
import pytest
import torch

from benchmark import run
from dervet_tpu_torch.ops import pdhg
from dervet_tpu_torch.scenario.scenario import MicrogridScenario

SOLVE = pdhg.CompiledLPSolver.solve


def unchanged(self, c=None, q=None, l=None, u=None, **kw):
    """A solve that hands back its starting point: x = 0 held to its box."""
    res = SOLVE(self, c=c, q=q, l=l, u=u, **kw)
    lo, hi = (torch.as_tensor(a, dtype=res.x.dtype).expand_as(res.x)
              for a in (l if l is not None else self.lp.l,
                        u if u is not None else self.lp.u))
    return res._replace(x=torch.clamp(torch.zeros_like(res.x), lo, hi))


def half(self, c=None, q=None, l=None, u=None, **kw):
    """Half of the batch solved, the rest given the solved half's answers."""
    B = c.shape[0]
    k = max(B // 2, 1)
    part = [a[:k] if torch.is_tensor(a) and a.dim() == 2 else a
            for a in (c, q, l, u)]
    res = SOLVE(self, *part, **kw)
    idx = torch.arange(B) % k
    return type(res)(*(f[idx] for f in res))


def altered(self, c=None, q=None, l=None, u=None, **kw):
    """Every answer altered where it is produced: one hour of the first
    variable block moved by 100."""
    res = SOLVE(self, c=c, q=q, l=l, u=u, **kw)
    x = res.x.clone()
    x[..., 1] += 100.0
    return res._replace(x=x)


def drive(root, workload, capsys):
    rc = run.main(["--workload", workload, "--seed", str(2 ** 31 + 77),
                   "--seconds", "0.1"], device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_sweep_is_correct(tiny_root, capsys):
    out = drive(tiny_root, "sweep-bess_pv_da-1000", capsys)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("fault", [unchanged, half, altered])
def test_sweep_fault_is_not_correct(fault, tiny_root, capsys, monkeypatch):
    monkeypatch.setattr(pdhg.CompiledLPSolver, "solve", fault)
    out = drive(tiny_root, "sweep-bess_pv_da-1000", capsys)
    assert out["correct"] is False
    assert list(out)[-1] == "checks"


# The fan-out's solves are certified by the program itself, which re-solves
# a bad answer and at last takes HiGHS's: a fault there reaches no user.
# Its faults are planted where a case's answer reaches its results, after
# the certificate: the dispatch scattered into the case's DERs.
SCATTER = MicrogridScenario._scatter_to_ders


def scatter_unchanged(self, solution):
    """Every case's dispatch left at its starting point, zero."""
    SCATTER(self, {k: np.zeros_like(v) for k, v in solution.items()})


def scatter_half(self, solution, last={}):
    """Every other case given the answer of the case before it."""
    if self.case.case_id % 2 and "solution" in last:
        solution = last["solution"]
    last["solution"] = solution
    SCATTER(self, solution)


def scatter_altered(self, solution):
    """Every case's dispatch altered: one hour of its first block by 100."""
    solution = {k: v.copy() for k, v in solution.items()}
    solution[next(iter(solution))][1] += 100.0
    SCATTER(self, solution)


@pytest.mark.parametrize("fault", [scatter_unchanged, scatter_half,
                                   scatter_altered])
def test_fanout_fault_is_not_correct(fault, tiny_root, capsys, monkeypatch):
    monkeypatch.setattr(MicrogridScenario, "_scatter_to_ders", fault)
    out = drive(tiny_root, "fanout-bess_pv_da-64", capsys)
    assert out["correct"] is False
