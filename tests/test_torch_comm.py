"""The comm layer, the port against the reference: codec streams, decodes
and bit counts (host, device and the reference's traced count), the bf16
value stream against ``ml_dtypes``, q8 against the sync's wire rounding,
the ledger and link graph, the depth-2 sync probe on the same state, and
the ``comm_bits`` benchmark twin. Everything is exact: streams byte for
byte, counts as integers, states and payloads as bit patterns."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from benchmarks import comm_bits as jbench
from repro.comm import accounting as jacc
from repro.comm import codecs as jcod
from repro.configs.base import HFLConfig as JHFLConfig
from repro.core import hfl as jhfl
from repro.optim import SGDM as JSGDM
from repro_torch.comm import accounting as tacc
from repro_torch.comm import codecs as tcod
from repro_torch.configs.base import HFLConfig as THFLConfig
from repro_torch.core import hfl as thfl
from repro_torch.launch import comm_bits as tbench
from repro_torch.utils import flatten as tfl
from repro_torch.utils.convert import state_from_numpy

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

CODEC_NAMES = sorted(tcod.CODECS)
SPARSE_NAMES = [n for n in CODEC_NAMES if n != "best" and not n.startswith("dense")]
SIZES = [(1, 1), (13, 5), (300, 1), (300, 299), (4096, 41)]
F32_MAX_BOUND = float(np.float32(1e20))  # float32 represents it exactly


def _payload(rng, size, k):
    idx = np.sort(rng.choice(size, k, replace=False)).astype(np.int32)
    vals = rng.normal(size=k).astype(np.float32)
    if k > 2:
        vals[0] = 0.0
    return vals, idx


# ---------------------------------------------------------------------------
# Codecs against the reference
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    assert tcod.list_codecs() == jcod.list_codecs()
    for name in jcod.list_codecs():
        assert tcod.get_codec(name).name == jcod.get_codec(name).name
        assert tcod.get_codec(name).value_format == jcod.get_codec(name).value_format
    with pytest.raises(KeyError):
        tcod.get_codec("nope")


@pytest.mark.parametrize("name", CODEC_NAMES)
def test_encode_decode_match_reference(name):
    tc, jc = tcod.get_codec(name), jcod.get_codec(name)
    rng = np.random.default_rng(0)
    for size, k in SIZES:
        v, i = _payload(rng, size, k)
        blob = tc.encode(v, i, size)
        assert blob.dtype == np.uint8
        np.testing.assert_array_equal(blob, jc.encode(v, i, size))
        tv, ti = tc.decode(blob, size)
        jv, ji = jc.decode(blob, size)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
        # tensors are read where they lie, unsorted input canonicalized
        perm = rng.permutation(k)
        np.testing.assert_array_equal(
            tc.encode(torch.from_numpy(v[perm]), torch.from_numpy(i[perm]), size),
            blob)


@pytest.mark.parametrize("name", CODEC_NAMES)
def test_measure_bits_match_reference(name):
    tc, jc = tcod.get_codec(name), jcod.get_codec(name)
    rng = np.random.default_rng(1)
    for size, k in SIZES:
        v, i = _payload(rng, size, k)
        n = 8 * len(tc.encode(v, i, size))
        assert tc.measure_bits(v, i, size) == jc.measure_bits(v, i, size) == n
        got = tc.measure_bits_torch(torch.from_numpy(v), torch.from_numpy(i), size)
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == int(jc.measure_bits_jax(jnp.asarray(v), jnp.asarray(i),
                                                  size)) == n


@pytest.mark.parametrize("name", CODEC_NAMES)
def test_measure_bits_torch_with_duplicates_and_empty(name):
    """Duplicate indices (the (0, 0) pads of a threshold payload) and the
    empty payload count as the host path counts them."""
    tc, jc = tcod.get_codec(name), jcod.get_codec(name)
    v = np.array([0.5, 0.0, 0.0, -2.0], np.float32)
    i = np.array([7, 0, 0, 3], np.int32)
    for vv, ii in ((v, i), (v[:0], i[:0])):
        want = jc.measure_bits(vv, ii, 20)
        assert tc.measure_bits(vv, ii, 20) == want
        assert int(tc.measure_bits_torch(torch.from_numpy(vv),
                                         torch.from_numpy(ii), 20)) == want


@pytest.mark.parametrize("name", CODEC_NAMES)
def test_measure_bits_torch_exact_past_int32(name):
    """int64 device counts stay exact where the reference's int32 traced
    count would wrap: gaps of 2^40 in a 2^41-entry vector."""
    tc = tcod.get_codec(name)
    size = 1 << 41
    i = np.array([3, 1 << 40, (1 << 40) + 1, (1 << 41) - 1], np.int64)
    v = np.ones(4, np.float32)
    want = tc.measure_bits(v, i, size)
    assert int(tc.measure_bits_torch(torch.from_numpy(v), torch.from_numpy(i),
                                     size)) == want


# ---------------------------------------------------------------------------
# Value formats
# ---------------------------------------------------------------------------


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _bf16_cases():
    rng = np.random.default_rng(2)
    hi = rng.integers(0, 1 << 16, 64, dtype=np.uint32) << 16
    ties = _f32(hi | 0x8000)  # exactly halfway: to even
    near = _f32(hi | rng.integers(0, 1 << 16, 64, dtype=np.uint32))
    sub = _f32(rng.integers(1, 1 << 23, 64, dtype=np.uint32)
               | (rng.integers(0, 2, 64, dtype=np.uint32) << 31))
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.5, 3.4e38,
                        float(np.finfo(np.float32).max)], np.float32)
    x = np.concatenate([ties, near, sub, special])
    return x[np.isfinite(x) | np.isinf(x)]


def test_bf16_bytes_match_ml_dtypes():
    x = _bf16_cases()
    fmt = tcod._VALUE_FORMATS["bf16"]
    want = x.astype(ml_dtypes.bfloat16)
    assert fmt.encode(x) == want.tobytes()
    got, off = fmt.parse(fmt.encode(x), 0, x.size)
    assert off == 2 * x.size
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.astype(np.float32).view(np.int32))
    np.testing.assert_array_equal(fmt.wire(x).view(np.int32),
                                  want.astype(np.float32).view(np.int32))
    for n in (3, x.size):  # torch's scalar and vectorized casts
        assert fmt.encode(x[:n]) == jcod._VALUE_FORMATS["bf16"].encode(x[:n])


@pytest.mark.parametrize("n", [5, 40])  # torch's scalar and vectorized casts
def test_bf16_nan_is_the_quiet_nan_of_its_sign(n):
    nans = _f32([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFC12345, 0x7FA00000])
    x = np.resize(nans, n)
    got = np.frombuffer(tcod._VALUE_FORMATS["bf16"].encode(x), "<u2")
    want = np.where(np.signbit(x), 0xFFC0, 0x7FC0)
    np.testing.assert_array_equal(got, want)
    with np.errstate(invalid="ignore"):
        ref = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(got, ref)


def test_bf16_wire_matches_sync_rounding():
    x = _bf16_cases()
    got = tcod.get_codec("dense-bf16").wire_values(x)
    want = thfl._wire_round_rows(torch.from_numpy(x), "bf16").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n", [1, 257, 4096])
def test_q8_wire_matches_sync_rounding(n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = tcod.get_codec("bitmap-q8").wire_values(x)
    want = thfl._wire_round_rows(torch.from_numpy(x), "q8").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        got, np.asarray(jhfl._wire_round(jnp.asarray(x), "q8")))


def test_q8_decode_zero_has_no_sign():
    """A small negative value quantizes to code 0: ``wire_values`` gives
    -0.0, the decoded stream +0.0 (int8 has no sign of zero), in both
    packages; equal by value."""
    v = np.array([-1e-4, 1.0, -1.0], np.float32)
    i = np.array([0, 1, 2], np.int32)
    for cod in (tcod, jcod):
        c = cod.get_codec("delta-varint-q8")
        dv, _ = c.decode(c.encode(v, i, 3), 3)
        wire = c.wire_values(v)
        assert np.signbit(wire[0]) and not np.signbit(dv[0])
        np.testing.assert_array_equal(dv, wire)


@st.composite
def payloads(draw):
    size = draw(st.integers(1, 300))
    k = draw(st.integers(1, size))
    idx = draw(st.sets(st.integers(0, size - 1), min_size=k, max_size=k))
    vals = draw(st.lists(
        st.floats(-F32_MAX_BOUND, F32_MAX_BOUND, allow_nan=False,
                  allow_infinity=False, width=32),
        min_size=k, max_size=k))
    return np.asarray(vals, np.float32), np.asarray(sorted(idx), np.int32), size


@settings(max_examples=25, deadline=None)
@given(payloads(), st.sampled_from(CODEC_NAMES))
def test_property_roundtrip_and_measure(payload, name):
    """decode(encode(x)) == x up to the codec's wire rounding, and the host
    and device counts equal the stream length, for every codec."""
    v, i, size = payload
    codec = tcod.get_codec(name)
    blob = codec.encode(v, i, size)
    assert codec.measure_bits(v, i, size) == 8 * len(blob)
    assert int(codec.measure_bits_torch(torch.from_numpy(v), torch.from_numpy(i),
                                        size)) == 8 * len(blob)
    dense = np.zeros(size, np.float32)
    np.add.at(dense, i, v)
    if name in SPARSE_NAMES:
        dv, di = codec.decode(blob, size)
        np.testing.assert_array_equal(di, i)
        np.testing.assert_array_equal(dv, codec.wire_values(v))
    elif name.startswith("dense"):
        np.testing.assert_array_equal(codec.decode_dense(blob, size),
                                      codec.wire_values(dense))
    else:  # best: the winner's wire semantics
        winner, _ = codec.choose(v, i, size)
        want = winner.decode_dense(winner.encode(v, i, size), size)
        np.testing.assert_array_equal(codec.decode_dense(blob, size), want)


# ---------------------------------------------------------------------------
# Ledger, link graph, access links
# ---------------------------------------------------------------------------


def test_ledger_matches_reference():
    for depth in (2, 3):
        links = tacc.link_names(depth)
        assert links == jacc.link_names(depth)
        tl = tacc.PayloadLedger(codec="bitmap", size=100, links=links)
        jl = jacc.PayloadLedger(codec="bitmap", size=100, links=links)
        for led in (tl, jl):
            led.record("mu_ul", 800, events=4)
            led.record("sbs_ul", 300)
            led.record(links[-1], 200)
            with pytest.raises(KeyError):
                led.record("nope", 1)
        assert tl.summary() == jl.summary()
        assert tl.bits_access_total == jl.bits_access_total == 800
        assert tl.bits_fronthaul_total == jl.bits_fronthaul_total == 500
    assert tacc.LINKS == jacc.LINKS and tacc.link_names(2) == tacc.LINKS
    assert tacc.ACCESS_LINKS == jacc.ACCESS_LINKS
    assert tacc.FRONTHAUL_LINKS == jacc.FRONTHAUL_LINKS
    for t in range(5):
        assert tacc.boundary_links(t) == jacc.boundary_links(t)
    # the live metrics mirror: comm.bits / comm.payloads by link, the
    # reference's registry snapshot key for key
    from repro.obs import MetricsRegistry as JReg
    from repro_torch.obs import MetricsRegistry as TReg

    treg, jreg = TReg(), JReg()
    links = tacc.link_names(3)
    tl = tacc.PayloadLedger(codec="bitmap", size=100, links=links, registry=treg)
    jl = jacc.PayloadLedger(codec="bitmap", size=100, links=links, registry=jreg)
    for led in (tl, jl):
        assert led.record("mu_ul", 800, events=4) == 800.0
        led.record("t2_ul", 0.5)
        led.record("mu_ul", 16)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.snapshot()["comm.bits"]["series"] == {"link=mu_ul": 816.0,
                                                      "link=t2_ul": 0.5}
    assert tl.summary() == jl.summary()


@pytest.mark.parametrize("name", CODEC_NAMES)
def test_access_bits_match_reference(name):
    for size, phi in ((11_217, 0.0), (11_217, 0.9), (11_173_962, 0.99), (64, 0.5)):
        if size > 100_000 and name.startswith("delta-gamma"):
            continue  # the host gamma count is a Python loop over k
        assert (tacc.access_bits(name, size, phi)
                == jacc.access_bits(name, size, phi))


# ---------------------------------------------------------------------------
# The depth-2 sync probe on the same state
# ---------------------------------------------------------------------------


def _states(N, impl, mode="sparse", wire="bf16", betas=(0.5, 0.2), seed=0):
    tiers = ((1, 1, 0.99, 0.9), (N, 1, 0.9, 0.9) + tuple(betas))
    kw = dict(tiers=tiers, sync_mode=mode, omega_impl=impl, wire_format=wire)
    jcfg, tcfg = JHFLConfig(**kw), THFLConfig(**kw)
    params = {"a": jnp.zeros((40, 50)), "b": jnp.zeros((1000,))}  # Q = 3000
    state = jhfl.hfl_init(params, JSGDM(momentum=0.0), jcfg)
    rng = np.random.default_rng(seed)

    def perturb(tree, scale):
        return jax.tree.map(lambda p: jnp.asarray(
            np.asarray(p) + scale * rng.standard_normal(p.shape).astype(np.float32)),
            tree)

    state = state._replace(params=perturb(state.params, 0.1),
                           w_ref=perturb(state.w_ref, 0.1),
                           eps=perturb(state.eps, 0.01), e=perturb(state.e, 0.01))
    return jcfg, tcfg, state, state_from_numpy(jax.tree.map(np.asarray, state), "cpu")


def _snapshot(state):
    return [fl.view(torch.int32).clone() for fl in (
        tfl.pack_stacked(state.params)[0], tfl.pack(state.w_ref)[0],
        tfl.pack_stacked(state.eps)[0], tfl.pack(state.e)[0])]


def _check_probe(jcfg, tcfg, jstate, tstate, codec):
    jul, jdl = jacc.make_sync_probe(jcfg, codec)(jstate)
    probe = tacc.make_sync_probe(tcfg, codec)
    before = _snapshot(tstate)
    tul, tdl = probe(tstate)
    assert tul.dtype == tdl.dtype == torch.int64 and tul.shape == (jcfg.num_clusters,)
    np.testing.assert_array_equal(tul.numpy(), np.asarray(jul))
    assert int(tdl) == int(jdl)
    ups, (dvals, didx) = probe.payloads(tstate)
    for a, b in zip(_snapshot(tstate), before):  # the state is untouched
        assert torch.equal(a, b)
    # the payloads are what the port's own sync then sends
    wref0, eps0 = tfl.pack(tstate.w_ref)[0], tfl.pack_stacked(tstate.eps)[0]
    spec = tfl.spec_of(tstate.w_ref)
    drift = eps0.clone()
    thfl._pack_drift(drift, tstate.params, wref0, tcfg.tiers[1].beta_up, spec)
    new = thfl.make_sync(thfl.SyncPlan(tcfg))(tstate)
    want_wref = wref0.clone().index_add_(0, didx.long(), dvals)
    assert torch.equal(tfl.pack(new.w_ref)[0].view(torch.int32),
                       want_wref.view(torch.int32))
    eps1 = tfl.pack_stacked(new.eps)[0]
    for n, (vals, idx) in enumerate(ups):
        want = drift[n].index_add_(0, idx.long(), -vals)
        assert torch.equal(eps1[n].view(torch.int32), want.view(torch.int32))


IMPLS = ["topk", "hist", "pallas", "fused"]
PROBE_CODECS = ["delta-varint", "bitmap", "bitmap-q8", "best"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("codec", PROBE_CODECS)
def test_sync_probe_matches_reference(impl, codec):
    jcfg, tcfg, jstate, tstate = _states(2, impl)
    _check_probe(jcfg, tcfg, jstate, tstate, codec)


@pytest.mark.parametrize("wire", ["bf16", "q8"])
@pytest.mark.parametrize("impl", ["topk", "pallas"])
def test_sync_probe_quantized_matches_reference(wire, impl):
    jcfg, tcfg, jstate, tstate = _states(2, impl, "quantized_sparse", wire, seed=1)
    _check_probe(jcfg, tcfg, jstate, tstate, "bitmap")


@pytest.mark.parametrize("impl", IMPLS)
def test_sync_probe_three_clusters_uneven_betas(impl):
    """N = 3 with β_s = 0.4, β_m = 0.3: the drift fma and the f32(1/N)
    reciprocal multiply round differently from a re-derived formula."""
    jcfg, tcfg, jstate, tstate = _states(3, impl, betas=(0.4, 0.3), seed=2)
    _check_probe(jcfg, tcfg, jstate, tstate, "delta-varint")


def test_sync_probe_dense_is_static():
    jcfg, tcfg, jstate, tstate = _states(2, "topk", "dense")
    jul, jdl = jacc.make_sync_probe(jcfg, "bitmap")(jstate)
    tul, tdl = tacc.make_sync_probe(tcfg, "bitmap")(tstate)
    np.testing.assert_array_equal(tul, jul)
    assert tdl == jdl == 32.0 * 3000


def test_sync_probe_depth3_matches_reference():
    """On a depth-3 config ``make_sync_probe`` probes the flat sync over all
    N = 4 clusters with tier 1's φ and β, as the reference's does (the
    tiered cascade's own probe is ``make_hier_sync_probe``)."""
    kw = dict(tiers=((1, 1, 0.99, 0.9), (2, 1, 0.9, 0.9, 0.4, 0.3), (2, 2)),
              omega_impl="hist")
    jcfg, tcfg = JHFLConfig(**kw), THFLConfig(**kw)
    params = {"a": jnp.zeros((40, 50)), "b": jnp.zeros((1000,))}
    state = jhfl.hfl_init(params, JSGDM(momentum=0.0), jcfg)
    rng = np.random.default_rng(3)
    state = state._replace(params=jax.tree.map(lambda p: jnp.asarray(
        np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32)),
        state.params))
    tstate = state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    jul, jdl = jacc.make_sync_probe(jcfg, "delta-varint")(state)
    tul, tdl = tacc.make_sync_probe(tcfg, "delta-varint")(tstate)
    assert tul.shape == (4,)
    np.testing.assert_array_equal(tul.numpy(), np.asarray(jul))
    assert int(tdl) == int(jdl)


# ---------------------------------------------------------------------------
# The comm_bits benchmark twin
# ---------------------------------------------------------------------------


def test_comm_bits_twin_matches_reference():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4096,)))
    want_rows, want = jbench.run(4096)
    rows, got = tbench.run(4096, x=x, device="cpu")
    for key in ("bits_per_param", "best_winner_by_phi",
                "bitmap_to_delta_crossover_phi",
                "sparse_codecs_beating_analytic_at_0.99",
                "analytic_bits_per_param"):
        assert got[key] == want[key], key
    assert [r[0] for r in rows] == [r[0] for r in want_rows]
    assert rows[-1] == want_rows[-1] and got["device"] == "cpu"


@pytest.mark.parametrize("phi", [0.0, 0.9, 0.99, 0.999])
def test_latency_payload_matches_reference(phi):
    from repro.wireless.latency import LatencyParams as JLatencyParams
    from repro_torch.wireless.latency import LatencyParams as TLatencyParams

    for q in (11.2e6, 11173962.0, 4096.0):
        assert TLatencyParams(model_params=q).payload(phi) == \
            JLatencyParams(model_params=q).payload(phi)
    assert TLatencyParams().payload(phi) == JLatencyParams().payload(phi)
