"""DeepSeek-V2-Lite in the port (the port's own architecture: the reference
has none) against the plain PyTorch reference of the benchmark
(``hflbench/reference/deepseek_v2_lite.py``, nothing of ``repro`` or
``repro_torch``), at tiny widths on seeded random weights, in f32 on the
CPU: MLA without a query LoRA under YaRN, the ``scale`` of the attention
kernels' plain route, the dropless router that does not renormalise and
its per-sequence balance loss, the held-expert layer's grouped rows, the
leading dense block, the whole model's loss and gradients, one HFL round
with its sync, and the expert-parallel share test.

Tolerances: both sides compute the same f32 function in another order
of operations (flash attention's online softmax against a full softmax,
the grouped experts against a loop over tokens): 1e-5 relative on losses
and outputs, and on gradients 1e-4 of the leaf's largest entry (the
backward adds K slots and the attention tiles in other orders, so a
small entry of a leaf carries its large neighbours' round-off).
"""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hflbench.check import gaps  # noqa: E402
from hflbench.reference import deepseek_v2_lite as R  # noqa: E402
from hflbench.reference.lm import _unflatten, named_leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import HFLConfig, TierConfig  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    flash_attn_bwd_plain, flash_attn_fwd_plain,
)
from repro_torch.launch.steps import make_loss_fn  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.common import model_rope_angles, yarn_correction_range  # noqa: E402
from repro_torch.models.transformer import decode_step, forward, init_model, prefill  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry, use_registry  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

torch.set_num_threads(2)

TINY = dict(num_layers=3, first_k_dense=1, d_model=64, num_heads=4, num_kv_heads=4, d_ff=96,
            moe_d_ff=32, num_experts=8, experts_per_token=3, experts_held=2, experts_offset=2,
            num_shared_experts=2, kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, vocab_size=256, dtype="float32")
CFG = dataclasses.replace(get_config("deepseek-v2-lite"), **TINY)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-4


def _close_grad(a, b, name=""):
    """|a - b| within GRAD_REL of b's largest entry."""
    assert float((a - b).abs().max()) <= GRAD_REL * float(b.abs().max()), name


def _cfg(**kw):
    return dataclasses.replace(CFG, **kw)


def _ref_m(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _params(cfg, seed=0):
    return init_model(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _tokens(cfg, B=2, T=24, seed=1):
    return torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(seed))


def _x(shape, seed=2, scale=1.0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * scale


def _grads(fn, leaves):
    req = [t.detach().clone().requires_grad_(True) for t in leaves]
    out = fn(req)
    return out, torch.autograd.grad(out if out.dim() == 0 else out.sum(), req, allow_unused=True)


# -- YaRN and MLA ---------------------------------------------------------

def test_yarn_correction_range_at_the_published_settings():
    # 64 rope dims, θ 10,000, β_fast 32, β_slow 1 over 4,096 positions
    assert yarn_correction_range(64, 10000.0, 32.0, 1.0, 4096) == (10, 23)
    assert R.yarn_range(64, 10000.0, 32, 1, 4096) == (10, 23)


def test_yarn_tables_and_mla_scale_match_the_reference():
    full = get_config("deepseek-v2-lite")
    pos = torch.arange(4096)
    cos, sin = model_rope_angles(pos, 64, full)
    rc, rs = R.rope_tables(4096, _ref_m(full), "cpu")
    # the port rounds the f64 table once, the published module computes it in f32
    torch.testing.assert_close(cos, rc, rtol=0, atol=2e-4)
    torch.testing.assert_close(sin, rs, rtol=0, atol=2e-4)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert R.softmax_scale(_ref_m(full)) == pytest.approx(192 ** -0.5 * m * m)
    assert R.softmax_scale(_ref_m(full)) == pytest.approx(0.114721, abs=1e-6)


def test_mla_without_a_query_lora_matches_the_reference_forward_and_grads():
    cfg = _cfg()
    p = A.init_mla(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert "w_q" in p and "w_dq" not in p and p["w_q"].shape == (64, 4 * 24)
    x = _x((2, 40, 64))
    names, leaves = zip(*named_leaves(p))
    cos, sin = R.rope_tables(40, _ref_m(cfg), "cpu")
    old_block, R.Q_BLOCK = R.Q_BLOCK, 16  # several query blocks, a short last one
    try:
        got, gg = _grads(lambda l: A.mla_forward(_unflatten(names, l), x, cfg).square().sum(), leaves)
        want, gw = _grads(lambda l: R.mla(x, _unflatten(names, l), cos, sin, _ref_m(cfg),
                                          R.mm_f32).square().sum(), leaves)
    finally:
        R.Q_BLOCK = old_block
    torch.testing.assert_close(got, want, **LOSS_TOL)
    for name, a, b in zip(names, gg, gw):
        _close_grad(a, b, name)


def test_flash_attention_plain_route_takes_a_scale():
    q, k, v = _x((2, 20, 4, 24), 4), _x((2, 20, 2, 24), 5), _x((2, 20, 2, 16), 6)
    do = _x((2, 20, 4, 16), 7)
    # the default is 1/√Dk, bit for bit
    o0, l0 = flash_attn_fwd_plain(q, k, v, q_chunk=8, kv_chunk=8)
    o1, l1 = flash_attn_fwd_plain(q, k, v, q_chunk=8, kv_chunk=8, scale=1.0 / math.sqrt(24))
    assert torch.equal(o0, o1) and torch.equal(l0, l1)
    scale = 0.31
    o, lse = flash_attn_fwd_plain(q, k, v, q_chunk=8, kv_chunk=8, scale=scale)
    kr, vr = (t.repeat_interleave(2, dim=2).transpose(1, 2) for t in (k, v))
    qr = q.transpose(1, 2).requires_grad_(True)
    kr, vr = kr.requires_grad_(True), vr.requires_grad_(True)
    s = (qr @ kr.transpose(-1, -2)) * scale
    s = s.masked_fill(torch.ones(20, 20, dtype=torch.bool).triu(1), float("-inf"))
    want = (torch.softmax(s, -1) @ vr).transpose(1, 2)
    torch.testing.assert_close(o, want, **LOSS_TOL)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), **LOSS_TOL)
    dq, dk, dv = flash_attn_bwd_plain(q, k, v, o, lse, do, q_chunk=8, kv_chunk=8, scale=scale)
    gq, gk, gv = torch.autograd.grad(want, [qr, kr, vr], do)
    _close_grad(dq, gq.transpose(1, 2))
    _close_grad(dk, gk.transpose(1, 2).reshape(2, 20, 2, 2, 24).sum(3))
    _close_grad(dv, gv.transpose(1, 2).reshape(2, 20, 2, 2, 16).sum(3))
    # the autograd route carries it to the backward
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = A.flash_attention(qa, ka, va, q_chunk=8, kv_chunk=8, scale=scale)
    torch.testing.assert_close(out, o, **LOSS_TOL)
    ga = torch.autograd.grad(out, [qa, ka, va], do)
    for a, b in zip(ga, (dq, dk, dv)):
        _close_grad(a, b)


# -- the expert layer -----------------------------------------------------

def _moe_params(cfg, seed=8):
    return M.init_moe(torch.Generator().manual_seed(seed), cfg, device="cpu")


@pytest.mark.parametrize("norm_topk_prob", [False, True])
def test_dropless_router_and_per_sequence_balance_loss_match_the_reference(norm_topk_prob):
    cfg = _cfg(norm_topk_prob=norm_topk_prob, experts_held=0, experts_offset=0)
    p = _moe_params(cfg)
    x = _x((2, 30, 64), 9)
    y, aux = M.held_moe_forward(p, x, cfg)
    yr, auxr = R.moe(x, p, _ref_m(_cfg(norm_topk_prob=norm_topk_prob, experts_held=8,
                                       experts_offset=0)), R.mm_f32)
    torch.testing.assert_close(y, yr, **LOSS_TOL)
    torch.testing.assert_close(aux, auxr, **LOSS_TOL)
    # the gates are the chosen probabilities: without renormalising they sum below 1
    probs, gates, _ = R.route(x.reshape(60, 64), p["router"], _ref_m(cfg))
    sums = gates.sum(-1)
    assert torch.allclose(sums, torch.ones(60)) == norm_topk_prob
    # per sequence: an even router gives 1 for each sequence
    even = {**p, "router": torch.zeros_like(p["router"])}
    assert float(M.held_moe_forward(even, x, cfg)[1]) == pytest.approx(1.0)


@pytest.mark.parametrize("norm_topk_prob", [False, True])
def test_capacity_router_honours_norm_topk_prob(norm_topk_prob):
    # the capacity layer (dbrx's) with room for every slot (C = T) drops nothing, so
    # its output is the dropless reference's under either setting of the switch
    cfg = _cfg(dropless=False, experts_held=0, experts_offset=0, capacity_factor=8 / 3,
               norm_topk_prob=norm_topk_prob)
    p = _moe_params(cfg)
    x = _x((2, 30, 64), 12)
    y, _ = M.moe_forward(p, x, cfg)
    yr, _ = R.moe(x, p, _ref_m(_cfg(norm_topk_prob=norm_topk_prob, experts_held=8,
                                    experts_offset=0)), R.mm_f32)
    torch.testing.assert_close(y, yr, **LOSS_TOL)
    r = M.route_tables(x[0], p["router"], cfg)
    kept = r["idx"] < 30
    assert int(kept.sum()) == 30 * 3
    assert torch.allclose(r["gts"].sum(0).new_zeros(30).index_add(
        0, r["idx"][kept], r["gts"][kept]), torch.ones(30)) == norm_topk_prob


def test_held_slot_rows_are_grouped_aligned_and_keep_token_order():
    cfg = _cfg(num_experts=8, experts_held=3, experts_offset=4)
    ids = torch.stack([torch.randperm(8, generator=torch.Generator().manual_seed(s))[:3]
                       for s in range(50)])
    rows, held, ends, counts, R_ = M.held_slot_rows(ids, cfg)
    flat = ids.reshape(-1)
    assert torch.equal(held, (flat >= 4) & (flat < 7))
    assert torch.equal(counts, torch.stack([(flat == 4 + j).sum() for j in range(3)]))
    assert ends.dtype == torch.int32 and all(int(e) % M.ALIGN == 0 for e in ends)
    assert int(ends[-1]) <= R_ and torch.all(rows[~held] == R_)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32), ends[:-1]])
    for j in range(3):
        mine = rows[flat == 4 + j]
        # the expert's slots in token order, from its aligned start on
        assert torch.equal(mine, starts[j] + torch.arange(int(counts[j])))
    assert len(set(rows[held].tolist())) == int(held.sum())


def test_share_test_over_all_shares_adds_up_to_the_whole_layer():
    # expert parallelism: E 8 over 4 chips, 2 held each (offsets 0/2/4/6); the routed
    # parts of every share plus the shared experts once = the uncut layer
    whole = _cfg(experts_held=0, experts_offset=0)
    p = _moe_params(whole)
    x = _x((2, 30, 64), 10)
    want, aux_whole = R.moe(x, p, _ref_m(_cfg(experts_held=8, experts_offset=0)), R.mm_f32)
    shared = R.swiglu(x, p["shared"], R.mm_f32)
    total = shared.clone()
    for off in (0, 2, 4, 6):
        cfg = _cfg(experts_held=2, experts_offset=off)
        part = {**p, **{k: p[k][off:off + 2] for k in ("w_gate", "w_up", "w_down")}}
        y, aux = M.held_moe_forward(part, x, cfg)
        total += y - shared  # what every share computes alike is counted once
        torch.testing.assert_close(aux, aux_whole, **LOSS_TOL)  # the router is every chip's
    torch.testing.assert_close(total, want, **LOSS_TOL)


def test_grouped_route_equals_the_loop_route():
    cfg = _cfg(experts_held=3, experts_offset=1)
    p = {k: v.bfloat16() if k != "router" else v for k, v in _moe_params(cfg).items()
         if k != "shared"}
    x = _x((64, 64), 11).bfloat16()
    ids = torch.sort(torch.softmax(x.float() @ p["router"], -1), dim=-1, descending=True,
                     stable=True)[1][:, :3]
    rows, held, ends, _, R_ = M.held_slot_rows(ids, cfg)
    dout = _x((64 * 3, 64), 12).bfloat16()
    outs = []
    orig = M._grouped_route
    for route in (lambda t: True, lambda t: False):  # torch._grouped_mm on the CPU, the loop
        M._grouped_route = route
        try:
            leaves = [x] + [p[k] for k in ("w_gate", "w_up", "w_down")]
            req = [t.clone().requires_grad_(True) for t in leaves]
            y = M.HeldExperts.apply(*req, rows, held, ends, R_)
            outs.append([y] + list(torch.autograd.grad(y, req, dout)))
        finally:
            M._grouped_route = orig
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.all(outs[0][0][~held] == 0)


def test_routed_calls_counter_names_the_route():
    cfg = _cfg()
    reg = MetricsRegistry()
    with use_registry(reg):
        M.held_moe_forward(_moe_params(cfg), _x((1, 8, 64)), cfg)
    assert reg.counter("moe.routed_calls").value(route="plain") == 1.0
    assert reg.counter("moe.routed_calls").value(route="grouped") == 0.0


def test_grouped_route_reads_nothing_back_to_the_host():
    # the card's route at the published widths, on meta tensors: they hold no data, so
    # any device->host read (item, tolist, nonzero, cpu) in the forward, the backward
    # or the tally would raise here
    d, f, E, Eh = 2048, 1408, 64, 16
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), experts_held=Eh, experts_offset=16)

    def leaf(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, device="meta", dtype=dtype, requires_grad=True)

    p = {"router": leaf(d, E, dtype=torch.float32), "w_gate": leaf(Eh, d, f),
         "w_up": leaf(Eh, d, f), "w_down": leaf(Eh, f, d),
         "shared": {"w_gate": leaf(d, 2 * f), "w_up": leaf(d, 2 * f), "w_down": leaf(2 * f, d)}}
    x = leaf(2, 256, d)
    reg = MetricsRegistry()
    with use_registry(reg), M.tally_load() as tally:
        y, aux = M.held_moe_forward(p, x, cfg)
        (y.float().sum() + aux).backward()
    assert reg.counter("moe.routed_calls").value(route="grouped") == 1.0
    assert x.grad.shape == x.shape and p["w_down"].grad.shape == (Eh, f, d)
    assert tally[Eh].shape == (Eh,)


def test_load_tally_sums_each_held_experts_slots():
    cfg = _cfg()
    p = _moe_params(cfg)
    with M.tally_load() as tally:
        for s in (13, 14):
            M.held_moe_forward(p, _x((2, 10, 64), s), cfg)
    M.held_moe_forward(p, _x((2, 10, 64), 15), cfg)  # outside: not tallied
    want = torch.zeros(2, dtype=torch.long)
    for s in (13, 14):
        x = _x((2, 10, 64), s).reshape(20, 64)
        _, _, top = R.route(x, p["router"], _ref_m(cfg))
        want += torch.stack([(top == 2 + j).sum() for j in range(2)])
    assert list(tally) == [2] and torch.equal(tally[2], want)


# -- the stack and the model ----------------------------------------------

def test_first_k_dense_stack_layout():
    p = _params(CFG)
    assert p["dense_blocks"]["ffn"]["w_gate"].shape == (1, 64, 96)
    assert "router" not in p["dense_blocks"]["ffn"]
    assert p["blocks"]["ffn"]["router"].shape == (2, 64, 8)
    assert p["blocks"]["ffn"]["w_gate"].shape == (2, 2, 64, 32)  # 2 of 8 experts held
    assert p["blocks"]["ffn"]["shared"]["w_gate"].shape == (2, 64, 64)
    assert p["lm_head"].shape == (64, 256) and "w_q" in p["blocks"]["attn"]
    n = sum(t.numel() for t in tree_flatten(p)[0])
    mla = 64 * 96 + 64 * 40 + 32 + 32 * 4 * 32 + 64 * 64
    want = (2 * 256 * 64 + 64 + (mla + 3 * 64 * 96 + 128)
            + 2 * (mla + 2 * 3 * 64 * 32 + 3 * 64 * 64 + 64 * 8 + 128))
    assert n == want


@pytest.mark.parametrize("held", [(2, 2), (8, 0)])
def test_whole_model_loss_and_grads_match_the_reference(held):
    cfg = _cfg(experts_held=held[0], experts_offset=held[1])
    p = _params(cfg)
    tok = _tokens(cfg)
    names, leaves = zip(*named_leaves(p))
    loss_fn = make_loss_fn(cfg)
    got, gg = _grads(lambda l: loss_fn(_unflatten(names, l), {"tokens": tok})[0], leaves)
    old_block, R.Q_BLOCK = R.Q_BLOCK, 16
    try:
        want, gw = _grads(lambda l: R.moe_loss(_unflatten(names, l), tok, _ref_m(cfg)), leaves)
    finally:
        R.Q_BLOCK = old_block
    torch.testing.assert_close(got, want, **LOSS_TOL)
    for name, a, b in zip(names, gg, gw):
        assert (a is None) == (b is None), name
        if a is not None:
            _close_grad(a, b, name)


def test_one_hfl_round_with_its_sync_matches_the_reference():
    from repro_torch.core.hfl import SyncPlan, hfl_init, make_cluster_train_step, make_sync
    from repro_torch.core.schedule import run_hfl
    from repro_torch.optim import SGDM, constant_lr

    cfg, N, H = CFG, 2, 2
    hfl = {"clusters": N, "period": H, "phi": [0.99, 0.9, 0.9, 0.9], "beta_s": 0.5,
           "beta_m": 0.2, "momentum": 0.9, "lr": 0.1}
    hcfg = HFLConfig(tiers=(TierConfig(fanout=1, period=1, phi_up=0.99, phi_down=0.9),
                            TierConfig(fanout=N, period=H, phi_up=0.9, phi_down=0.9,
                                       beta_up=0.5, beta_down=0.2)),
                     momentum=0.9, sync_mode="sparse", omega_impl="hist")
    w0 = _params(cfg, 4)
    opt = SGDM(momentum=0.9)
    state = hfl_init(w0, opt, hcfg)
    batches = [torch.stack([_tokens(cfg, seed=10 * s + n) for n in range(N)]) for s in range(H)]
    losses = []
    state = run_hfl(state, make_cluster_train_step(make_loss_fn(cfg), opt, constant_lr(0.1)),
                    make_sync(SyncPlan(hcfg)), iter({"tokens": b} for b in batches), H, H,
                    on_step=lambda s, st, l: losses.append([float(v) for v in l]))
    names = [n for n, _ in named_leaves(w0)]
    change = {}
    for (n, w), (_, pn) in zip(named_leaves(w0), named_leaves(state.params)):
        change[n] = [float(torch.linalg.vector_norm(pn[i] - w)) for i in range(N)]
    for (n, w), (_, r) in zip(named_leaves(w0), named_leaves(state.w_ref)):
        change["w_ref/" + n] = [float(torch.linalg.vector_norm(r - w))]
    grad1 = {n: [1.0] * N for n in names}  # the first step's gradients: tested above
    ref = R.hfl_readings(w0, batches, _ref_m(cfg), hfl, H, rule="hist")
    out = gaps({"loss": losses, "grad1": grad1, "change": change},
               {**ref, "grad1": grad1})
    # every row adopted the new reference: the round's sync happened on both sides
    for n, _ in named_leaves(w0):
        assert change[n][0] == change[n][1]
    assert out["loss_gap"] < 1e-5 and out["change_gap"] < 1e-3, out


def test_prefill_then_decode_equals_the_forward():
    cfg = _cfg(experts_held=0, experts_offset=0)
    p = _params(cfg)
    tok = _tokens(cfg, T=14)
    with torch.no_grad():
        full, _ = forward(p, tok, cfg)
        _, cache = prefill(p, tok[:, :10], cfg, max_len=14)
        for s in range(10, 14):
            logits, cache = decode_step(p, cache, tok[:, s:s + 1], cfg)
            torch.testing.assert_close(logits[:, 0], full[:, s], rtol=1e-4, atol=1e-4)
