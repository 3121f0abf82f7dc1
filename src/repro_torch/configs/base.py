"""Config schema: the port's copy of ``repro.configs.base``.

``ModelConfig`` (with ``reduced()``), ``ShapeConfig`` and ``INPUT_SHAPES``,
``TierConfig``, ``HFLConfig`` (the per-tier ``tiers`` API, with the legacy
scalar keywords and their deprecated read shims), ``parse_tiers_spec``,
``warn_legacy_cli_flag`` and ``SimConfig``, field for field and with the
reference's warning texts.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.obs.config import ObsConfig


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (transformer / SSM / MoE / hybrid)."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    sliding_window: int = 0
    rope_theta: float = 10000.0
    # YaRN (DeepSeek-V2's rope_scaling): factor 0 leaves RoPE unscaled
    yarn_factor: float = 0.0
    yarn_original_max_pos: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    # the port's own MoE settings (the reference has none of them): routing
    # without capacity or drops (``models.moe.held_moe_forward``, with
    # DeepSeek-V2's per-sequence balance loss summed over the layers, where
    # the capacity layer's Switch loss is averaged over them), the top-K
    # gates renormalised or not (either layer), the experts this layer holds
    # (0: all) from ``experts_offset`` on, and ``first_k_dense`` leading
    # blocks with a dense FFN of ``d_ff``
    dropless: bool = False
    norm_topk_prob: bool = True
    experts_held: int = 0
    experts_offset: int = 0
    first_k_dense: int = 0

    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    attn_every: int = 0

    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    act: str = "silu"  # silu | gelu
    gated_mlp: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    frontend: str = "none"
    frontend_tokens: int = 0

    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / sliding-window)."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family (<=2 layers, d_model<=512)."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4) if self.num_heads else 0
        num_kv = max(1, min(self.num_kv_heads, num_heads)) if num_heads else 0
        kw = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=(d_model // num_heads) if num_heads else 0,
        )
        if self.num_experts:
            kw.update(
                num_experts=min(self.num_experts, 4),
                experts_per_token=min(self.experts_per_token, 2),
                moe_d_ff=min(self.moe_d_ff, 128),
                num_shared_experts=min(self.num_shared_experts, 1),
            )
        if self.use_mla:
            kw.update(kv_lora_rank=64, q_lora_rank=64 if self.q_lora_rank else 0,
                      qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32)
        if self.experts_held:
            kw.update(experts_held=min(self.experts_held, 2), experts_offset=0)
        if self.first_k_dense:
            kw.update(first_k_dense=1)
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_headdim=32,
                      ssm_chunk=32)
        if self.attn_every:
            kw.update(attn_every=2)
        if self.sliding_window:
            kw.update(sliding_window=64)
        if self.frontend != "none":
            kw.update(frontend_tokens=min(self.frontend_tokens, 16))
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (the dry-run's)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TierConfig:
    """One aggregation stage of the hierarchy, bottom-up (see
    ``repro.configs.base.TierConfig``): ``tiers[0]`` is MU<->SBS,
    ``tiers[-1]`` the root."""

    fanout: int
    period: int = 1
    phi_up: float = 0.0
    phi_down: float = 0.0
    beta_up: float = 0.0
    beta_down: float = 0.0
    discipline: str = "lockstep"

    def __post_init__(self):
        if self.fanout < 1:
            raise ValueError(f"TierConfig.fanout must be >= 1, got {self.fanout}")
        if self.period < 1:
            raise ValueError(f"TierConfig.period must be >= 1, got {self.period}")
        for nm in ("phi_up", "phi_down"):
            v = getattr(self, nm)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"TierConfig.{nm} must be in [0, 1), got {v}")
        if self.discipline not in ("lockstep", "deadline", "async"):
            raise ValueError(f"unknown tier discipline {self.discipline!r}")


# legacy scalar HFLConfig fields -> their depth-2 tier slot; both the
# constructor shim and the deprecated read-properties are driven off this
_LEGACY_HFL_FIELDS = (
    "num_clusters", "mus_per_cluster", "period",
    "phi_mu_ul", "phi_sbs_dl", "phi_sbs_ul", "phi_mbs_dl",
    "beta_s", "beta_m",
)

# warn-once-per-process registry for the deprecated field reads and CLI flags
_legacy_hfl_warned: set = set()


def _warn_legacy_hfl_field(name: str, hint: str) -> None:
    if name in _legacy_hfl_warned:
        return
    _legacy_hfl_warned.add(name)
    warnings.warn(
        f"HFLConfig.{name} is deprecated; {hint} (the scalar two-level "
        "fields were replaced by the per-tier HFLConfig.tiers tuple)",
        DeprecationWarning, stacklevel=3,
    )


def _reset_legacy_hfl_warnings() -> None:
    """Test hook: re-arm the once-per-process deprecation warnings."""
    _legacy_hfl_warned.clear()


def warn_legacy_cli_flag(flag: str, replacement: str) -> None:
    """Once-per-process deprecation for the old CLI surface
    (``--clusters/--mus/--period`` -> ``--tiers``); shares the warned-set
    (and the test reset hook) with the field shims."""
    key = f"cli:{flag}"
    if key in _legacy_hfl_warned:
        return
    _legacy_hfl_warned.add(key)
    warnings.warn(
        f"{flag} is deprecated; use {replacement} instead",
        DeprecationWarning, stacklevel=3,
    )


# the old HFLConfig() defaults, expressed as the depth-2 tier tuple
DEFAULT_TIERS = (
    TierConfig(fanout=4, period=1, phi_up=0.99, phi_down=0.9),
    TierConfig(fanout=1, period=4, phi_up=0.9, phi_down=0.9,
               beta_up=0.5, beta_down=0.2),
)


def parse_tiers_spec(spec: str) -> Tuple[TierConfig, ...]:
    """``--tiers`` grammar ``FANOUTS[:H=PERIODS][:async]`` -> tier tuple.

    Fan-outs are listed root-down (``4x2`` = 4 clusters x 2 MUs), periods
    bottom-up; defaults are the historical per-level phi/beta values.
    """
    parts = [p for p in spec.strip().split(":") if p]
    if not parts:
        raise ValueError(f"empty --tiers spec {spec!r}")
    try:
        fan_rd = [int(f) for f in parts[0].split("x")]
    except ValueError:
        raise ValueError(
            f"--tiers fan-outs must be integers, got {parts[0]!r}") from None
    if len(fan_rd) < 2:
        raise ValueError(
            f"--tiers needs >= 2 fan-outs (got {parts[0]!r}); the minimum "
            "hierarchy is CLUSTERSxMUS")
    periods: list = []
    root_async = False
    for p in parts[1:]:
        if p.startswith("H="):
            try:
                periods = [int(h) for h in p[2:].split(",")]
            except ValueError:
                raise ValueError(
                    f"--tiers periods must be integers, got {p!r}") from None
        elif p == "async":
            root_async = True
        else:
            raise ValueError(
                f"unknown --tiers segment {p!r}; expected 'H=...' or 'async'")
    fanouts = fan_rd[::-1]
    depth = len(fanouts)
    if len(periods) > depth - 1:
        raise ValueError(
            f"--tiers has {len(periods)} periods for {depth - 1} "
            "aggregation tier(s)")
    periods = periods + [1] * (depth - 1 - len(periods))
    tiers = [TierConfig(fanout=fanouts[0], period=1, phi_up=0.99, phi_down=0.9)]
    for t in range(1, depth):
        tiers.append(TierConfig(
            fanout=fanouts[t], period=periods[t - 1],
            phi_up=0.9, phi_down=0.9, beta_up=0.5, beta_down=0.2,
            discipline=("async" if root_async and t == depth - 1
                        else "lockstep"),
        ))
    return tuple(tiers)


@dataclass(frozen=True)
class HFLConfig:
    """Hierarchical FL + sparse communication parameters (paper §III-IV).

    The same fields and defaults as ``repro.configs.base.HFLConfig``;
    ``tiers`` accepts ``TierConfig``s, dicts or tuples. The legacy scalar
    constructor keywords (``num_clusters``, ``mus_per_cluster``,
    ``period``, ``phi_*``, ``beta_*``) reshape the depth-2 tuple; reading
    them back warns once per process (``DeprecationWarning``) and is only
    defined while the hierarchy is depth 2.
    """

    tiers: Tuple[TierConfig, ...] = DEFAULT_TIERS
    momentum: float = 0.9
    sync_mode: str = "sparse"  # dense | sparse | quantized_sparse
    omega_impl: str = "topk"  # topk | hist | pallas | fused
    sync_layout: str = "flat"
    flat_shards: int = 1
    wire_format: str = "bf16"  # bf16 | q8
    payload_accounting: str = "analytic"
    codec: str = "delta-varint"
    async_dl_sparse: bool = False

    def __init__(self, tiers=None, momentum: float = 0.9,
                 sync_mode: str = "sparse", omega_impl: str = "topk",
                 sync_layout: str = "flat", flat_shards: int = 1,
                 wire_format: str = "bf16",
                 payload_accounting: str = "analytic",
                 codec: str = "delta-varint", async_dl_sparse: bool = False,
                 **legacy):
        # dataclasses.replace() funnels unknown keys here too, so
        # replace(cfg, period=2) goes through the legacy shim
        unknown = set(legacy) - set(_LEGACY_HFL_FIELDS)
        if unknown:
            raise TypeError(
                f"HFLConfig got unexpected keyword(s) {sorted(unknown)}")
        if tiers is None:
            tiers = DEFAULT_TIERS
        tiers = tuple(
            t if isinstance(t, TierConfig)
            else TierConfig(**t) if isinstance(t, dict)
            else TierConfig(*t)
            for t in tiers)
        if len(tiers) < 2:
            raise ValueError("HFLConfig.tiers needs >= 2 stages "
                             "(MU tier + at least one aggregation tier)")
        if legacy:
            if len(tiers) != 2:
                raise ValueError(
                    f"legacy two-level keyword(s) {sorted(legacy)} are "
                    f"ambiguous on a depth-{len(tiers)} hierarchy; set "
                    "HFLConfig.tiers explicitly instead")
            t0, t1 = tiers
            t0 = dataclasses.replace(
                t0,
                fanout=legacy.get("mus_per_cluster", t0.fanout),
                phi_up=legacy.get("phi_mu_ul", t0.phi_up),
                phi_down=legacy.get("phi_sbs_dl", t0.phi_down))
            t1 = dataclasses.replace(
                t1,
                fanout=legacy.get("num_clusters", t1.fanout),
                period=legacy.get("period", t1.period),
                phi_up=legacy.get("phi_sbs_ul", t1.phi_up),
                phi_down=legacy.get("phi_mbs_dl", t1.phi_down),
                beta_up=legacy.get("beta_s", t1.beta_up),
                beta_down=legacy.get("beta_m", t1.beta_down))
            tiers = (t0, t1)
        for name, value in (
                ("tiers", tiers), ("momentum", momentum),
                ("sync_mode", sync_mode), ("omega_impl", omega_impl),
                ("sync_layout", sync_layout), ("flat_shards", flat_shards),
                ("wire_format", wire_format),
                ("payload_accounting", payload_accounting), ("codec", codec),
                ("async_dl_sparse", async_dl_sparse)):
            object.__setattr__(self, name, value)

    @property
    def depth(self) -> int:
        return len(self.tiers)

    def agg_count(self, tier: int) -> int:
        return math.prod(t.fanout for t in self.tiers[tier + 1:])

    @property
    def num_clusters(self) -> int:
        return self.agg_count(0)

    @property
    def mus_per_cluster(self) -> int:
        return self.tiers[0].fanout

    @property
    def total_mus(self) -> int:
        return math.prod(t.fanout for t in self.tiers)

    # --- deprecated scalar reads (warn once per process, depth-2 only) ---

    def _two_level(self) -> Tuple[TierConfig, TierConfig]:
        if len(self.tiers) != 2:
            raise AttributeError(
                "legacy two-level HFLConfig fields are undefined for a "
                f"depth-{len(self.tiers)} hierarchy; read cfg.tiers")
        return self.tiers  # type: ignore[return-value]

    @property
    def period(self) -> int:
        tiers = self._two_level()
        _warn_legacy_hfl_field("period", "read cfg.tiers[-1].period")
        return tiers[1].period

    @property
    def phi_mu_ul(self) -> float:
        tiers = self._two_level()
        _warn_legacy_hfl_field("phi_mu_ul", "read cfg.tiers[0].phi_up")
        return tiers[0].phi_up

    @property
    def phi_sbs_dl(self) -> float:
        tiers = self._two_level()
        _warn_legacy_hfl_field("phi_sbs_dl", "read cfg.tiers[0].phi_down")
        return tiers[0].phi_down

    @property
    def phi_sbs_ul(self) -> float:
        tiers = self._two_level()
        _warn_legacy_hfl_field("phi_sbs_ul", "read cfg.tiers[1].phi_up")
        return tiers[1].phi_up

    @property
    def phi_mbs_dl(self) -> float:
        tiers = self._two_level()
        _warn_legacy_hfl_field("phi_mbs_dl", "read cfg.tiers[1].phi_down")
        return tiers[1].phi_down

    @property
    def beta_s(self) -> float:
        tiers = self._two_level()
        _warn_legacy_hfl_field("beta_s", "read cfg.tiers[1].beta_up")
        return tiers[1].beta_up

    @property
    def beta_m(self) -> float:
        tiers = self._two_level()
        _warn_legacy_hfl_field("beta_m", "read cfg.tiers[1].beta_down")
        return tiers[1].beta_down


# ---------------------------------------------------------------------------
# Simulation (event-driven HCN scenario engine) config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimConfig:
    """Scenario knobs for the event-driven simulator (``repro_torch.sim``).

    The wireless side (cell geometry, rate model) lives in
    ``wireless.latency.LatencyParams``; this config holds everything the
    *fleet* and the *schedule* add on top: per-device compute speed,
    availability, mobility, and the sync discipline.
    """

    scenario: str = "paper-fig3"
    # lockstep (paper) | deadline (straggler drop) | async (own clocks,
    # staleness-weighted consensus)
    discipline: str = "lockstep"
    seed: int = 0
    base_compute_s: float = 0.05  # mean wall time of one local iteration
    compute_sigma: float = 0.0  # lognormal sigma of per-MU compute multiplier
    dropout: float = 0.0  # per-round MU unavailability probability
    # diurnal availability curve (0 = flat, the legacy behaviour):
    # unavail(t) = clip(dropout * (1 + amp * sin(2pi (t/period + phase))), 0, 1)
    diurnal_amp: float = 0.0
    diurnal_period_s: float = 86400.0
    diurnal_phase: float = 0.0
    speed_mps: float = 0.0  # random-waypoint speed; 0 = static (paper)
    deadline_factor: float = 1.5  # deadline = factor * median per-MU round time
    # --- client selection (participation-rate policies, sim.selection) ---
    # fraction of each cluster's available members picked per round; 1.0
    # keeps the legacy everyone-participates behaviour (no selector built)
    prate: float = 1.0
    # uniform -- unbiased per-round draw from the availability mask
    # biased  -- best-channel-first (top UL rate), the Pareto-front policy
    # kmeans  -- location-based k-means per cluster: one member nearest
    #            each of ceil(prate*members) centroids (coverage-preserving)
    selection: str = "uniform"
    staleness_exp: float = 1.0  # async weight = (1/N) * (1+staleness)^-exp
    reuse: int = 1  # frequency-reuse factor for the cluster coloring
    # --- trace-driven mobility replay (repro.sim.traces) ---
    # external CSV/JSONL trace to replay (columns t,mu_id,x,y); exclusive
    # with speed_mps > 0 and with trace_model
    trace_file: Optional[str] = None
    # synthetic trace generator to replay instead of a file:
    # random-waypoint | manhattan | hotspot-drift
    trace_model: Optional[str] = None
    trace_speed_mps: float = 0.0  # generator speed; 0 = the model's default
    trace_duration_s: float = 600.0  # generated trace length [virtual s]
    trace_dt_s: float = 5.0  # generator sample spacing [virtual s]
    # data residency as mobility re-associates MUs
    # (data.federated.ResidencyTracker):
    #   static    -- legacy: shards pinned to birth slots, no tracker
    #   move      -- the shard follows the MU's radio association
    #   duplicate -- every visited cluster keeps a copy
    #   stale     -- tracker attached but shards never leave the birth
    #                cluster (explicit control arm for the benchmark)
    residency: str = "static"
    # --- fleet scale (the million-MU regime) ---
    # physical MUs per cluster; None = hfl.mus_per_cluster (every MU owns a
    # training slot, the legacy 1:1 layout). Larger values oversubscribe:
    # the fleet is subsampled into the mpc training slots each round
    # (requires a residency tracker to pick the resident shards).
    fleet_mus_per_cluster: Optional[int] = None
    # UL rate pricing: "maxmin" = Alg. 2 max-min sub-carrier allocation
    # (exact, needs M >= members per cluster); "single" = shared single
    # sub-carrier M-QAM rates (any fleet size, streamed in chunks)
    rate_model: str = "maxmin"
    # mobility bookkeeping cadence [virtual s]: 0 = advance/re-associate/
    # re-price at every event (legacy); > 0 batches fleet movement and
    # re-pricing to at most once per interval (fleet-scale runs)
    reprice_interval_s: float = 0.0
    # fault injection for the health monitor: a cluster index whose MUs
    # are forced unavailable every round (masked AFTER the availability
    # RNG draw, so all other clusters' trajectories are untouched); None
    # = no fault. Drives the dead/starved-cluster anomaly rule.
    fault_dead_cluster: Optional[int] = None
    # observability (repro_torch.obs): None keeps telemetry fully off — the
    # engine resolves it to the shared null handle; an ObsConfig turns on
    # spans, metrics and (health=True) the learning-health monitor
    obs: Optional[ObsConfig] = None
