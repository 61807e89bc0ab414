"""The port's kernel self-test (multimodalvc_tpu_torch/ops/selftest.py)
against the JAX package's (multimodalvc_tpu/ops/selftest.py): the same
check names, the same records from the same arrays, a crash turned into a
red record, and every check green on the CPU through the plain versions
(the card runs them through the kernels: tests/test_torch_selftest_cuda.py)."""
import numpy as np
import pytest
from torch_parity import t  # noqa: F401 (sets one torch thread)

from multimodalvc_tpu.ops import selftest as jst
from multimodalvc_tpu_torch.ops import selftest as tst

RECORD_CASES = {
    "close": (np.linspace(0.0, 1.0, 12), np.linspace(0.0, 1.0, 12) + 1e-3, 2e-3, False),
    "far": (np.arange(6.0), np.arange(6.0) + np.array([0, 0, 0.5, 0, 0, 0]), 1e-2, False),
    "exact_equal": (np.arange(10), np.arange(10), 0.0, True),
    "exact_differ": (np.arange(10), np.r_[np.arange(9), 3], 0.0, True),
    "empty": (np.zeros((0, 3)), np.zeros((0, 3)), 0.0, False),
}


def test_the_checks_are_the_jax_checks():
    assert list(tst.CHECKS) == list(jst.CHECKS)
    assert len(tst.CHECKS) == 16


@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_records_are_the_jax_records(case):
    got, want, tol, exact = RECORD_CASES[case]
    assert tst._result(case, got, want, tol, exact) == jst._result(case, got, want, tol, exact)
    # and from tensors, as the checks hand them
    assert tst._result(case, t(got), t(want), tol, exact) == jst._result(case, got, want, tol,
                                                                         exact)


def test_worst_is_the_jax_worst():
    subs = [jst._result(f"x/{name}", *RECORD_CASES[name]) for name in ("close", "far")]
    assert tst._worst("x", subs) == jst._worst("x", subs)
    green = [jst._result(f"x/{name}", *RECORD_CASES[name])
             for name in ("close", "exact_equal", "empty")]
    assert tst._worst("x", green) == jst._worst("x", green)
    assert tst._worst("x", green)["ok"] and not tst._worst("x", subs)["ok"]


def test_run_all_turns_a_crash_into_a_red_record(monkeypatch):
    def broken(device):
        raise RuntimeError(f"kernel did not build for {device}")

    monkeypatch.setitem(tst.CHECKS, "int4_matmul", broken)
    (rec,) = tst.run_all(["int4_matmul"], device="cpu")
    assert rec == {"name": "int4_matmul", "max_err": float("inf"), "tol": 0.0, "ok": False,
                   "error": "RuntimeError: kernel did not build for cpu"}


def test_run_all_takes_the_names_and_the_device(monkeypatch):
    seen = []
    for name in tst.CHECKS:
        monkeypatch.setitem(tst.CHECKS, name, lambda device, name=name: seen.append(
            (name, device)) or {"name": name, "max_err": 0.0, "tol": 0.0, "ok": True})
    out = tst.run_all(["beam_topk", "flash_vjp"], device="cpu")
    assert [r["name"] for r in out] == ["flash_vjp", "beam_topk"]  # the registry's order
    assert seen == [("flash_vjp", "cpu"), ("beam_topk", "cpu")]


@pytest.mark.parametrize("name", list(tst.CHECKS))
def test_check_passes_on_the_cpu(name):
    """Every check on the CPU, where each entry runs its plain version:
    the check's inputs, oracle and tolerance hold (generate_smoke: the
    tiny generate's ancestry, gather and int8 decodes)."""
    (rec,) = tst.run_all([name], device="cpu")
    assert rec["ok"] and "error" not in rec, rec
