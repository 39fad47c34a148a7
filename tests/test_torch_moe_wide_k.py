"""B7's token gathers above 32 kept slots a token: the combine forward,
the dispatch backward and the combine backward's ``d_w`` at k 36 of E 40
(``chip_smoke.check_token_gathers``), held to a bound derived for an fp32
sum of n terms in another order than the plain version's
(``chip_smoke.moe_sum_limit``): per order, n - 1 roundings of the running
sum plus one of each product, each within 2^-24 of the terms' magnitudes,
so two orders are within ``2 n 2^-24`` of them; then one ulp of the
dtype for the final cast.  n is k for the two sums a token and D for
``d_w``'s dot a slot.  ``check_moe``'s few-term gate stays as it is.

The ``gpu`` tests run the kernels and skip without a card (run them with
``python -m pytest --noconftest -m gpu tests/test_torch_moe_wide_k.py``);
the CPU tests hold the gate itself: counting stand-ins that sum each
token's slots in reverse order (or in another tree) pass, and ones that
drop the slots past 32, count one twice or skip the weights fail.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from cordum_tpu_torch.ops import moe_dispatch as md

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["fp32", "bf16"]
CPU = torch.device("cpu")


def _case(dev, dtype, seed=11):
    return chip_smoke.moe_case(torch, dev, dtype, n=200, d=64, e=40, k=36, seed=seed)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("seed", [11, 12])
def test_token_gathers_above_32_slots_within_the_n_term_bound_on_card(dtype, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    case = _case(torch.device("cuda", 0), dtype, seed)
    out = chip_smoke.check_token_gathers(torch, case, f"k 36 of E 40, seed {seed}")
    assert set(out) == {"moe_token_gather", "moe_token_sum", "moe_token_dot"}


# ---------------------------------------------------------------------------
# the gate on the CPU, with stand-ins for the kernels
# ---------------------------------------------------------------------------


def _slot_terms(src, route, w):
    """``[N, k, D]`` fp32: each kept slot's row of ``src``, times its
    weight when ``w`` is given (dropped slots zero)."""
    pos = torch.where(route.keep, route.pos, 0).long()
    rows = src.float()[route.idx.long(), pos] * route.keep[..., None]
    return rows if w is None else rows * w[..., None].float()


def _sum(terms, order):
    """The fp32 sum over a token's slots: one slot at a time, in
    ``order`` (``"reverse"``), or pairwise (``"tree"``)."""
    if order == "tree":
        while terms.shape[1] > 1:
            half = terms.shape[1] // 2
            rest = terms[:, 2 * half:]
            terms = torch.cat([terms[:, :half] + terms[:, half:2 * half], rest], 1)
        return terms[:, 0]
    acc = torch.zeros_like(terms[:, 0])
    for j in reversed(range(terms.shape[1])):
        acc = acc + terms[:, j]
    return acc


def _stand_ins(monkeypatch, order="reverse", fault=None):
    """The three token gathers as fp32 sums in ``order``; ``fault``: the
    slots past 32 left out, one slot counted twice, or the weights left
    out of the combine."""
    def pick(terms):
        if fault == "past-32":
            return terms[:, :32]
        if fault == "twice":
            return torch.cat([terms, terms[:, :1]], 1)
        return terms

    def gather(src, route, w):
        terms = _slot_terms(src, route, None if fault == "no-weights" else w)
        return _sum(pick(terms), order).to(src.dtype)

    def token_sum(src, route):
        return _sum(pick(_slot_terms(src, route, None)), order).to(src.dtype)

    def token_dot(dy, src, route):
        prods = _slot_terms(src, route, None) * dy.float()[:, None, :]  # [N, k, D]
        n, k, d = prods.shape
        return _sum(prods.reshape(n * k, d, 1), order).reshape(n, k)

    monkeypatch.setattr(md, "moe_token_gather", gather)
    monkeypatch.setattr(md, "moe_token_sum", token_sum)
    monkeypatch.setattr(md, "moe_token_dot", token_dot)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("order", ["reverse", "tree"])
def test_sums_in_another_order_pass_the_gate(monkeypatch, dtype, order):
    _stand_ins(monkeypatch, order)
    out = chip_smoke.check_token_gathers(torch, _case(CPU, dtype), f"CPU, {order}")
    assert all(share <= 1.0 for _, share in out.values())


@pytest.mark.parametrize("fault", ["past-32", "twice", "no-weights"])
def test_the_gate_refuses_a_wrong_sum(monkeypatch, fault):
    _stand_ins(monkeypatch, "reverse", fault)
    with pytest.raises(AssertionError, match="beyond the 36-term bound"):
        chip_smoke.check_token_gathers(torch, _case(CPU, torch.float32), f"CPU, {fault}")


def test_the_case_keeps_more_than_32_slots_a_token():
    case = _case(CPU, torch.float32)
    route = md.moe_route(case["probs"], case["k"], case["cap"])
    assert route.keep.sum(1).max() > 32


def test_the_bound_is_the_derived_one():
    mag, want = torch.tensor([1.0]), torch.tensor([0.5])
    got = chip_smoke.moe_sum_limit(36, mag, want, "bfloat16")
    assert got.item() == pytest.approx(2.0**-7 * 0.5 + 72 * 2.0**-24)
    assert chip_smoke.moe_sum_limit(2, mag, want, "float32").item() == pytest.approx(
        2.0**-23 * 0.5 + 4 * 2.0**-24)
