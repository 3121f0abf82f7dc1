"""The port's copy of ``repro.wireless.latency`` (numpy only,
bit-identical): end-to-end per-iteration latency of FL vs HFL (paper eqs.
14-15, 18, 21).

Composes the sub-carrier allocator (Alg. 2), the M-QAM UL rate model, and the
rateless broadcast DL model over the HCN topology. Sparsification scales the
payload by (1-φ); ``index_bits`` > 0 additionally charges per-entry index
overhead (the paper charges none — keep 0 to reproduce its figures; it is
deprecated, ``comm.accounting.warn_index_bits_deprecated``).

Both latency entry points also accept *explicit* per-link bit counts, which
take precedence over the analytic ``payload(φ)``: the measured-bits path
(``repro_torch.comm``) prices events with the byte-accurate codec streams of
the real sync payloads instead of the idealized formula.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.obs.metrics import current_registry
from repro_torch.wireless.broadcast import broadcast_latency
from repro_torch.wireless.subcarrier import allocate_subcarriers
from repro_torch.wireless.topology import HCNTopology


def _emit_pricing(fn: str, fh_rate, theta_u, theta_d, gamma_dl) -> None:
    """Mirror one radio (re)pricing into the ambient metrics registry.

    The pricing functions have no handle to thread, so they emit into
    ``current_registry()`` — the shared ``NULL_REGISTRY`` unless a
    telemetry run installed a live one (one branch when disabled).
    """
    reg = current_registry()
    if not reg.enabled:
        return
    reg.counter("wireless.pricings").inc(fn=fn)
    reg.gauge("wireless.fh_rate_bps").set(fh_rate)
    reg.gauge("wireless.theta_u_s").set(theta_u)
    reg.gauge("wireless.theta_d_s").set(theta_d)
    reg.histogram("wireless.gamma_dl_s").observe(gamma_dl)


@dataclass
class LatencyParams:
    M: int = 300  # total OFDM sub-carriers (paper §V-A text)
    B0: float = 30e3  # sub-carrier spacing [Hz]
    noise_total_db: float = -150.0  # N0*B0 per sub-carrier [dB]
    p_mbs: float = 20.0  # [W]
    p_sbs: float = 6.3
    p_mu: float = 0.2
    alpha: float = 2.8
    ber: float = 1e-3
    model_params: float = 11.2e6  # Q (ResNet18)
    bits_per_param: float = 32.0  # Q̂
    fronthaul_gain: float = 100.0  # SBS<->MBS vs access links
    # DEPRECATED: per transmitted entry (0 = paper's accounting). The
    # measured path (payload_accounting="measured") counts the real index
    # streams byte-accurately; a nonzero value there double-charges them
    # (comm.accounting warns). Kept at 0 for figure reproduction.
    index_bits: float = 0.0

    @property
    def n0(self) -> float:
        return 10.0 ** (self.noise_total_db / 10.0) / self.B0

    def payload(self, phi: float) -> float:
        frac = 1.0 - phi
        return self.model_params * frac * (self.bits_per_param + self.index_bits * (phi > 0))


def tier_payload_bits(lp: LatencyParams, tiers, overrides=None) -> dict:
    """Per-boundary payload bits of an arbitrary-depth tier tree.

    -> ``{link_name: bits}`` over :func:`repro_torch.comm.accounting.link_names`
    of ``len(tiers)``: boundary 0 is the access hop priced from
    ``tiers[0].phi_up/phi_down``, boundary ``t >= 1`` the fronthaul hop
    priced from ``tiers[t]``. ``overrides`` (link name -> bits, e.g. the
    measured codec streams) take precedence over the analytic
    ``lp.payload(φ)`` — the same contract ``hfl_latency``'s
    ``payload_bits`` dict has for the depth-2 links, extended to every
    boundary of the tree."""
    from repro_torch.comm.accounting import boundary_links

    ov = overrides or {}
    out = {}
    for t, tc in enumerate(tiers):
        ul, dl = boundary_links(t)
        out[ul] = ov.get(ul, lp.payload(tc.phi_up))
        out[dl] = ov.get(dl, lp.payload(tc.phi_down))
    return out


def fl_latency(
    topo: HCNTopology, mu_pos, lp: LatencyParams, *,
    phi_ul=0.0, phi_dl=0.0, ul_bits=None, dl_bits=None,
):
    """Per-iteration FL latency T^FL = T^UL + T^DL (MUs <-> MBS directly).

    ``ul_bits``/``dl_bits``: explicit payload bit counts (e.g. measured
    codec streams) overriding the analytic ``lp.payload(φ)``.
    """
    d = topo.dist_to_mbs(mu_pos)
    kw = dict(B0=lp.B0, Pmax=lp.p_mu, N0=lp.n0, alpha=lp.alpha, ber=lp.ber)
    _, rates = allocate_subcarriers(d, lp.M, **kw)
    ul_bits = lp.payload(phi_ul) if ul_bits is None else ul_bits
    dl_bits = lp.payload(phi_dl) if dl_bits is None else dl_bits
    t_ul = ul_bits / rates.min()
    t_dl = broadcast_latency(
        d, dl_bits, M=lp.M, B0=lp.B0, Pmax=lp.p_mbs, N0=lp.n0, alpha=lp.alpha
    )
    return t_ul + t_dl, {"t_ul": t_ul, "t_dl": t_dl}


def hfl_latency(
    topo: HCNTopology,
    mu_pos,
    cid,
    lp: LatencyParams,
    *,
    H: int = 1,
    phi_mu_ul=0.0,
    phi_sbs_dl=0.0,
    phi_sbs_ul=0.0,
    phi_mbs_dl=0.0,
    reuse: int = 1,
    payload_bits=None,
):
    """Average per-iteration HFL latency Γ^HFL = Γ^period / H (paper eq. 21).

    ``payload_bits``: optional dict overriding the analytic per-link
    payloads with explicit bit counts (keys among ``mu_ul``, ``sbs_dl``,
    ``sbs_ul``, ``mbs_dl`` — the measured-accounting hook).
    """
    pb = payload_bits or {}
    bits_mu_ul = pb.get("mu_ul", lp.payload(phi_mu_ul))
    bits_sbs_dl = pb.get("sbs_dl", lp.payload(phi_sbs_dl))
    bits_sbs_ul = pb.get("sbs_ul", lp.payload(phi_sbs_ul))
    bits_mbs_dl = pb.get("mbs_dl", lp.payload(phi_mbs_dl))
    colors, n_colors = topo.coloring(reuse)
    m_cluster = lp.M // n_colors  # sub-carriers available inside one cluster
    kw = dict(B0=lp.B0, Pmax=lp.p_mu, N0=lp.n0, alpha=lp.alpha, ber=lp.ber)

    gamma_ul, gamma_dl, mean_ul, mu_rates = [], [], [], []
    mu_rate_flat = np.full(len(cid), np.inf)
    for n in range(topo.num_clusters):
        sel = cid == n
        if not np.any(sel):
            # mobility can empty a cluster; it then contributes no latency
            gamma_ul.append(0.0)
            gamma_dl.append(0.0)
            mu_rates.append(np.zeros(0))
            continue
        d = topo.dist_to_sbs(mu_pos[sel], cid[sel])
        _, rates = allocate_subcarriers(d, m_cluster, **kw)
        mu_rates.append(rates)
        mu_rate_flat[sel] = rates
        gamma_ul.append(bits_mu_ul / rates.min())
        mean_ul.append(rates.mean())
        gamma_dl.append(
            broadcast_latency(
                d, bits_sbs_dl, M=m_cluster, B0=lp.B0, Pmax=lp.p_sbs,
                N0=lp.n0, alpha=lp.alpha,
            )
        )
    gamma_ul, gamma_dl = np.array(gamma_ul), np.array(gamma_dl)

    # fronthaul (SBS <-> MBS): paper assumes 100x the access-link rate
    fh_rate = lp.fronthaul_gain * float(np.mean(mean_ul)) if mean_ul else np.inf
    theta_u = bits_sbs_ul / fh_rate
    theta_d = bits_mbs_dl / fh_rate

    per_cluster = H * (gamma_ul + gamma_dl)
    gamma_period = per_cluster.max() + theta_u + theta_d + gamma_dl.max()
    per_iter = gamma_period / H
    # effective per-cluster broadcast rate (bits/s) realized by the
    # rateless DL model at this payload: callers re-price a broadcast
    # event carrying b bits as b / dl_rate without re-running the
    # Monte-Carlo (broadcast time is ~linear in bits at these payloads)
    with np.errstate(divide="ignore", invalid="ignore"):
        dl_rates = np.where(gamma_dl > 0, bits_sbs_dl / gamma_dl, np.inf)
    _emit_pricing("hfl_latency", fh_rate, theta_u, theta_d, gamma_dl)
    return per_iter, {
        "gamma_ul": gamma_ul, "gamma_dl": gamma_dl,
        "theta_u": theta_u, "theta_d": theta_d,
        # fronthaul rate so callers can re-price θ from per-event measured
        # bit counts without re-running the allocator
        "fh_rate": fh_rate,
        # per-cluster effective DL broadcast rates (per-event repricing)
        "dl_rates": dl_rates,
        # per-cluster per-MU UL rates (the simulator's deadline discipline
        # charges each MU its own UL time, not just the cluster min)
        "mu_rates": mu_rates, "m_cluster": m_cluster,
        # the same rates scattered to MU-id order [K] (the vectorized
        # engine prices whole fleets with one gather, no per-cluster lists)
        "mu_rate_flat": mu_rate_flat,
    }


# ---------------------------------------------------------------------------
# Fleet-scale pricing (rate_model="single"): no per-MU sub-carrier allocation
# ---------------------------------------------------------------------------
#
# Alg. 2's max-min allocation assumes every MU owns at least one of the M
# sub-carriers, which stops being physical (and crashes) once a cluster
# holds more MUs than sub-carriers. The *_single variants price fleets of
# any size with the shared-single-subcarrier model the 100k latency sweep
# established: each MU's UL rate is its optimal truncated-inversion M-QAM
# rate on ONE sub-carrier (``qam.optimal_rate_vec``, streamed in chunks),
# and the rateless broadcast DL is evaluated on the ``dl_probe`` farthest
# members per cell — the worst-instantaneous-SNR minimum that governs the
# rateless code is dominated by the far tail, so the probe subset is a
# deterministic, cheap stand-in for the whole cell. Both return the same
# aux schema as their exact counterparts (``mu_rates`` is None: per-cluster
# rate lists would be fleet-sized; use ``mu_rate_flat``).


def _farthest_subset(d: np.ndarray, limit: int) -> np.ndarray:
    """Indices of the ``limit`` largest distances (any order)."""
    if len(d) <= limit:
        return np.arange(len(d))
    return np.argpartition(d, len(d) - limit)[len(d) - limit:]


def fl_latency_single(
    topo: HCNTopology, mu_pos, lp: LatencyParams, *,
    phi_ul=0.0, phi_dl=0.0, ul_bits=None, dl_bits=None,
    dl_probe: int = 64, chunk: int = 1 << 18,
):
    """Fleet-scale ``fl_latency``: single-subcarrier UL, probe-subset DL."""
    from repro_torch.wireless.qam import optimal_rate_vec

    d = topo.dist_to_mbs(mu_pos)
    rates = optimal_rate_vec(
        d, m=1, B0=lp.B0, Pmax=lp.p_mu, N0=lp.n0, alpha=lp.alpha, ber=lp.ber,
        chunk=chunk)
    ul_bits = lp.payload(phi_ul) if ul_bits is None else ul_bits
    dl_bits = lp.payload(phi_dl) if dl_bits is None else dl_bits
    t_ul = ul_bits / rates.min()
    sub = _farthest_subset(d, dl_probe)
    t_dl = broadcast_latency(
        d[sub], dl_bits, M=lp.M, B0=lp.B0, Pmax=lp.p_mbs, N0=lp.n0,
        alpha=lp.alpha)
    return t_ul + t_dl, {"t_ul": t_ul, "t_dl": t_dl}


def hfl_latency_single(
    topo: HCNTopology,
    mu_pos,
    cid,
    lp: LatencyParams,
    *,
    H: int = 1,
    phi_mu_ul=0.0,
    phi_sbs_dl=0.0,
    phi_sbs_ul=0.0,
    phi_mbs_dl=0.0,
    reuse: int = 1,
    payload_bits=None,
    dl_probe: int = 64,
    chunk: int = 1 << 18,
):
    """Fleet-scale ``hfl_latency``: one streamed ``optimal_rate_vec`` call
    prices every MU at once; per-cluster reductions are ufunc scatters, so
    cost is O(K) with no per-MU (or per-cluster) Python work on the rate
    path. Same return contract as ``hfl_latency`` (``mu_rates`` aux is
    None — use ``mu_rate_flat``)."""
    from repro_torch.wireless.qam import optimal_rate_vec

    pb = payload_bits or {}
    bits_mu_ul = pb.get("mu_ul", lp.payload(phi_mu_ul))
    bits_sbs_dl = pb.get("sbs_dl", lp.payload(phi_sbs_dl))
    bits_sbs_ul = pb.get("sbs_ul", lp.payload(phi_sbs_ul))
    bits_mbs_dl = pb.get("mbs_dl", lp.payload(phi_mbs_dl))
    colors, n_colors = topo.coloring(reuse)
    m_cluster = lp.M // n_colors
    N = topo.num_clusters
    cid = np.asarray(cid)

    d = topo.dist_to_sbs(mu_pos, cid)
    rates = optimal_rate_vec(
        d, m=1, B0=lp.B0, Pmax=lp.p_mu, N0=lp.n0, alpha=lp.alpha, ber=lp.ber,
        chunk=chunk)

    counts = np.bincount(cid, minlength=N)
    nonempty = counts > 0
    min_rate = np.full(N, np.inf)
    np.minimum.at(min_rate, cid, rates)
    sum_rate = np.zeros(N)
    np.add.at(sum_rate, cid, rates)
    gamma_ul = np.where(nonempty, bits_mu_ul / min_rate, 0.0)

    # rateless broadcast on the dl_probe farthest members of each cell
    gamma_dl = np.zeros(N)
    order = np.lexsort((-d, cid))  # by cluster, farthest member first
    starts = np.searchsorted(cid[order], np.arange(N + 1))
    for n in np.nonzero(nonempty)[0]:
        sub = order[starts[n]:min(starts[n] + dl_probe, starts[n + 1])]
        gamma_dl[n] = broadcast_latency(
            d[sub], bits_sbs_dl, M=m_cluster, B0=lp.B0, Pmax=lp.p_sbs,
            N0=lp.n0, alpha=lp.alpha)

    with np.errstate(invalid="ignore"):
        mean_per_cluster = sum_rate[nonempty] / counts[nonempty]
    fh_rate = (lp.fronthaul_gain * float(mean_per_cluster.mean())
               if nonempty.any() else np.inf)
    theta_u = bits_sbs_ul / fh_rate
    theta_d = bits_mbs_dl / fh_rate

    per_cluster = H * (gamma_ul + gamma_dl)
    gamma_period = per_cluster.max() + theta_u + theta_d + gamma_dl.max()
    per_iter = gamma_period / H
    with np.errstate(divide="ignore", invalid="ignore"):
        dl_rates = np.where(gamma_dl > 0, bits_sbs_dl / gamma_dl, np.inf)
    _emit_pricing("hfl_latency_single", fh_rate, theta_u, theta_d, gamma_dl)
    return per_iter, {
        "gamma_ul": gamma_ul, "gamma_dl": gamma_dl,
        "theta_u": theta_u, "theta_d": theta_d,
        "fh_rate": fh_rate, "dl_rates": dl_rates,
        "mu_rates": None, "m_cluster": m_cluster,
        "mu_rate_flat": rates,
    }
