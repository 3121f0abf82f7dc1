"""The yardstick: peaks of one H100 and the work of each measured kernel and
step, counted from the configuration's shapes (never from the program).

Peaks: NVIDIA's data sheet for the H100 SXM part at its 700 W limit, dense
rates: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them,
3.35 TB/s of HBM.  A kernel's roofline share counts each byte of its
function's inputs read once and each byte of its outputs written once.
"""
from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM = 3.35e12
TILE = 256 * 1024  # the DGC kernels' (256 x 1024) tile: rows are padded to whole tiles
BINS = 64


def padded_vocab(vocab: int) -> int:
    return vocab if vocab % 512 == 0 or vocab < 512 else -(-vocab // 512) * 512


def lm_matrix_params(m: dict) -> int:
    """Entries of the layers' projection matrices."""
    d, f, H, Hkv, D = m["d_model"], m["d_ff"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    return m["num_layers"] * (2 * d * H * D + 2 * d * Hkv * D + 3 * d * f)


def lm_flat_size(m: dict) -> int:
    """Q: the flat vector of the port's tree (padded embedding, the layers'
    matrices, one norm placeholder a norm)."""
    return padded_vocab(m["vocab_size"]) * m["d_model"] + lm_matrix_params(m) + 2 * m["num_layers"] + 1


def tiles(q: int) -> int:
    """Entries of a row of q padded to whole tiles."""
    return -(-q // TILE) * TILE


def lm_forward_flops_per_token(m: dict, seq: int) -> float:
    """The forward's products a token: every projection, the tied head over
    the vocabulary, and attention's two products at the causal half."""
    attn = 2 * 2 * (seq / 2) * m["num_heads"] * m["head_dim"] * m["num_layers"]
    return 2 * lm_matrix_params(m) + 2 * m["d_model"] * m["vocab_size"] + attn


def attention_flops(m: dict, rows: int, seq: int, products: int) -> float:
    """``products`` attention products of one layer's call, each 2·T·S·d over
    the causal half, for ``rows`` sequences."""
    return products * rows * m["num_heads"] * seq * seq * m["head_dim"]


def resnet_forward_flops(m: dict) -> float:
    """The convolutions' and the classifier's products of one image."""
    h, w, c = m["image"]
    ch = [max(8, int(x * m["width"])) for x in (64, 128, 256, 512)]
    conv = lambda ho, wo, k, ci, co: 2 * ho * wo * k * k * ci * co
    total = conv(h, w, 3, c, ch[0])
    cin = ch[0]
    for si, (co, stride) in enumerate(zip(ch, (1, 2, 2, 2))):
        for bi in range(2):
            st = stride if bi == 0 else 1
            h, w = -(-h // st), -(-w // st)
            total += conv(h, w, 3, cin, co) + conv(h, w, 3, co, co)
            if st != 1 or cin != co:
                total += conv(h, w, 1, cin, co)
            cin = co
    return total + 2 * cin * m["num_classes"]


def bytes_share(trace, kernel_names, counted_by, bytes_per_call):
    """% of the HBM roofline: calls x bytes a call over the kernels' device
    time; None when the trace holds no such kernel."""
    if trace is None:
        return None
    secs = sum(trace.kernels(k)[0] for k in kernel_names)
    calls = trace.kernels(counted_by)[1]
    if not calls or secs <= 0:
        return None
    return 100.0 * calls * bytes_per_call / HBM / secs


def flops_share(trace, kernel_names, counted_by, flops_per_call, peak=PEAK_BF16):
    if trace is None:
        return None
    secs = sum(trace.kernels(k)[0] for k in kernel_names)
    calls = trace.kernels(counted_by)[1]
    if not calls or secs <= 0:
        return None
    return 100.0 * calls * flops_per_call / peak / secs


def idle_share(trace, profiled_units: int, unit_s: float):
    """% of a round (or iteration) with no operation on the device: the
    device's busy time a unit of the profiled ones over a unit's time in the
    window that follows them, which the profiler's own host work does not
    stretch."""
    if trace is None or not profiled_units or unit_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / profiled_units / unit_s)


SELECT_TILE = 64 * 1024  # block_select's tile


def keep_count(size: int, phi: float) -> int:
    return max(1, int(round((1.0 - phi) * size)))


def block_select_bytes(n: int, k: int) -> int:
    """One ``block_select`` call on a row of n entries keeping k: the row read
    once, and the function's outputs (candidate values f32 and indices int32
    in every tile's fixed slots, one int32 count a tile) written once.  The
    slots a tile gets: the candidate capacity k + k/4 + max(n/24, 128) + 2048
    spread over the tiles, plus a quarter and 64."""
    cap = min(n, k + k // 4 + max(n // 24, 128) + 2048)
    nb = -(-n // SELECT_TILE)
    per = -(-cap // nb)
    slots = min(SELECT_TILE, per + per // 4 + 64)
    return 4 * n + 4 + nb * slots * 8 + nb * 4
