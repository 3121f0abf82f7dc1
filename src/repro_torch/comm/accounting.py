"""Measured-bits payload accounting: the port of ``repro.comm.accounting``.

  * ``PayloadLedger``    -- per-link record of measured bits over the
                            tier-boundary link graph (``link_names``):
                            ``mu_ul`` (MU->SBS access uplink), ``sbs_dl``
                            (SBS->MU broadcast downlink), ``sbs_ul`` /
                            ``mbs_dl`` (SBS<->MBS fronthaul), and at depth
                            > 2 ``t{t}_ul`` / ``t{t}_dl`` per boundary.
  * ``make_sync_probe``  -- from the live ``HFLState``, the exact
                            ``(values, indices)`` payloads the flat sync is
                            about to send and their codec-measured bits
                            (``measure_bits_torch``: only 0-d counts, on
                            the state's device, no host sync).
  * ``make_hier_sync_probe`` -- the same for the depth > 2 cascade, per
                            boundary, from ``(state, bufs, top)``.
  * ``access_bits``      -- the access links' price: the codec applied to
                            a synthetic payload with the exact keep count
                            and uniformly spread indices (the per-MU train
                            step never materializes those payloads).

  * ``warn_index_bits_deprecated`` -- once per process, when the
                            simulator prices with a nonzero
                            ``LatencyParams.index_bits``.

With ``registry`` set, every ``PayloadLedger.record`` also feeds the
``comm.bits`` / ``comm.payloads`` counters of that metrics registry,
labelled by link.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from repro_torch.comm.codecs import Codec, get_codec

LINKS = ("mu_ul", "sbs_dl", "sbs_ul", "mbs_dl")
ACCESS_LINKS = ("mu_ul", "sbs_dl")
FRONTHAUL_LINKS = ("sbs_ul", "mbs_dl")


def boundary_links(t: int) -> tuple:
    """``(uplink, downlink)`` link names of tier boundary ``t``: boundary 0
    is the access hop, boundary 1 the first fronthaul hop (the paper's
    historical names), deeper boundaries ``t{t}_ul`` / ``t{t}_dl``."""
    if t == 0:
        return ("mu_ul", "sbs_dl")
    if t == 1:
        return ("sbs_ul", "mbs_dl")
    return (f"t{t}_ul", f"t{t}_dl")


def link_names(depth: int) -> tuple:
    """All link names of a depth-``depth`` hierarchy, boundary-major;
    ``link_names(2) == LINKS``."""
    out = []
    for t in range(depth):
        out.extend(boundary_links(t))
    return tuple(out)


# ---------------------------------------------------------------------------
# Ledger
# ---------------------------------------------------------------------------


@dataclass
class PayloadLedger:
    """Per-link measured-bit totals for one run over ``links`` (default:
    the depth-2 four-link graph)."""

    codec: str
    size: int  # Q: flat model length the payloads index into
    links: tuple = LINKS
    bits: Dict[str, float] = None
    events: Dict[str, int] = None
    # live metrics mirror (repro_torch.obs): when set, every record() also
    # feeds the ``comm.bits`` / ``comm.payloads`` counters, labelled by link
    registry: object = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.bits is None:
            self.bits = {l: 0.0 for l in self.links}
        if self.events is None:
            self.events = {l: 0 for l in self.links}

    def record(self, link: str, bits, *, events: int = 1) -> float:
        if link not in self.bits:
            raise KeyError(f"unknown link {link!r}; choose from {self.links}")
        b = float(bits)
        self.bits[link] += b
        self.events[link] += events
        if self.registry is not None:
            self.registry.counter("comm.bits").inc(b, link=link)
            self.registry.counter("comm.payloads").inc(events, link=link)
        return b

    @property
    def bits_access_total(self) -> float:
        return sum(self.bits[l] for l in ACCESS_LINKS)

    @property
    def bits_fronthaul_total(self) -> float:
        return sum(b for l, b in self.bits.items() if l not in ACCESS_LINKS)

    def summary(self) -> dict:
        out = {"codec": self.codec, "payload_size": self.size}
        for l in self.links:
            out[f"bits_{l}"] = self.bits[l]
            out[f"events_{l}"] = self.events[l]
        total_payloads = sum(self.events.values())
        if total_payloads:
            out["bits_per_param_mean"] = (
                sum(self.bits.values()) / (total_payloads * self.size)
            )
        return out


# ---------------------------------------------------------------------------
# Synthetic access-link measurement
# ---------------------------------------------------------------------------


@lru_cache(maxsize=256)
def _access_bits_cached(codec_name: str, size: int, phi: float) -> int:
    from repro_torch.core.sparsify import keep_count

    codec = get_codec(codec_name)
    if phi <= 0.0:
        idx = np.arange(size, dtype=np.int32)
        return int(codec.measure_bits(np.ones(size, np.float32), idx, size))
    k = keep_count(size, phi)
    # uniformly spread indices (strictly increasing for k <= size)
    idx = np.floor(np.arange(k) * (size / k)).astype(np.int32)
    return int(codec.measure_bits(np.ones(k, np.float32), idx, size))


def access_bits(codec: "str | Codec", size: int, phi: float) -> int:
    """Measured bits of a synthetic uniform-index payload: the per-iteration
    access-link price under a codec."""
    name = codec if isinstance(codec, str) else codec.name
    return _access_bits_cached(name, int(size), float(phi))


# ---------------------------------------------------------------------------
# Fronthaul probe: measure the REAL sync payloads
# ---------------------------------------------------------------------------


def make_sync_probe(hfl_cfg, codec: "str | Codec"):
    """-> ``probe(state) -> (sbs_ul_bits [N] int64, mbs_dl_bits 0-d int64)``,
    tensors on the state's device, with ``probe.payloads(state) ->
    ([(values, indices)] * N uplinks, (values, indices) downlink)``.

    The payloads come from the flat sync's own ``core.hfl.
    flat_sync_payloads`` (drift, Ω route, wire rounding, Σ sent, δ), so
    the measured payload IS the transmitted one. The sync forms them in
    its buffers in place; the probe hands it scratch copies of eps [N, Q]
    and e [Q] and leaves the state as it was. Run it before the sync on
    the same state. ``sync_mode="dense"`` ships the raw model both ways:
    static 32·Q bits per hop. On a depth > 2 config it probes the flat
    sync over all N clusters with tier 1's φ and β, as the reference's
    does; the cascade's own probe is ``make_hier_sync_probe``."""
    from repro_torch.core import hfl as H
    from repro_torch.utils import flatten as fl

    codec = get_codec(codec) if isinstance(codec, str) else codec
    N = hfl_cfg.num_clusters

    if hfl_cfg.sync_mode == "dense":
        def dense_probe(state):
            Q = fl.spec_of(state.w_ref).total
            return np.full(N, 32.0 * Q), np.float64(32.0 * Q)

        return dense_probe

    def payloads(state):
        wref, e, eps, ref_spec, _ = H._sync_buffers(state, N)
        ups = []
        down = H.flat_sync_payloads(hfl_cfg, state.params, wref, e.clone(),
                                    eps.clone(), ref_spec,
                                    on_up=lambda v, i: ups.append((v, i)))
        return ups, down

    def probe(state):
        Q = fl.spec_of(state.w_ref).total
        ups, (dvals, didx) = payloads(state)
        ul = torch.stack([codec.measure_bits_torch(v, i, Q) for v, i in ups])
        return ul, codec.measure_bits_torch(dvals, didx, Q)

    probe.payloads = payloads
    return probe


def make_hier_sync_probe(hfl_cfg, codec: "str | Codec"):
    """-> ``probe(state, bufs, top) -> (uls, dls)`` for depth > 2:
    ``uls[t-1]`` the [A_{t-1}] int64 bits of the uplinks crossing
    boundary t, ``dls[t-1]`` the [A_t] bits of its downlinks, tensors on
    the state's device. The payloads come from the cascade's own code
    (``core.hfl.hier_payloads``) on two scratch [Q] rows, with the live
    tier buffers; the state and the buffers are left as they were. Run it
    before the sync on the same ``(state, bufs)``."""
    from repro_torch.core import hfl as H
    from repro_torch.utils import flatten as fl

    codec = get_codec(codec) if isinstance(codec, str) else codec

    def probe(state, bufs, top):
        Q = fl.spec_of(state.w_ref).total
        top = int(top)
        uls, dls = [[] for _ in range(top)], [[] for _ in range(top)]
        H.hier_payloads(
            hfl_cfg, state, bufs, top,
            on_up=lambda t, v, i: uls[t - 1].append(codec.measure_bits_torch(v, i, Q)),
            on_down=lambda t, v, i: dls[t - 1].append(codec.measure_bits_torch(v, i, Q)))
        return (tuple(torch.stack(b) for b in uls),
                tuple(torch.stack(b) for b in dls))

    return probe


# ---------------------------------------------------------------------------
# index_bits deprecation
# ---------------------------------------------------------------------------


_index_bits_warned = False


def warn_index_bits_deprecated(lp) -> None:
    """``LatencyParams.index_bits`` is deprecated under both accounting
    modes: measured accounting counts the real codec index streams (a
    nonzero value double-charges them) and analytic accounting reproduces
    the paper's Q·(1-φ)·bits_per_param. Warns once per process."""
    global _index_bits_warned
    if _index_bits_warned or not getattr(lp, "index_bits", 0.0):
        return
    _index_bits_warned = True
    warnings.warn(
        "LatencyParams.index_bits is deprecated: measured accounting "
        "already counts the real codec index streams (a nonzero value "
        "double-charges them), and analytic accounting should match the "
        "paper's Q*(1-phi)*bits_per_param. Keep index_bits=0 (the "
        "paper's accounting). This warning fires once per process.",
        DeprecationWarning,
        stacklevel=3,
    )
