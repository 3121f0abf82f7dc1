"""Plain ResNet-18 (CIFAR) and the paper's Alg. 5 iteration: the reference
the faithful cell is judged by (arXiv:1909.02362; He et al. 2016).

ResNet-18 for 32x32 inputs: a 3x3 stem, four stages of two basic blocks
(64, 128, 256, 512 channels; the first block of stages 2-4 at stride 2 with
a 1x1 projection), BatchNorm on the batch's statistics (population
variance), global average pooling, one linear layer.  Inputs are NHWC,
kernels HWIO, and "SAME" padding puts the odd extra row and column after
the image.  Everything runs in float32; TF32 is off unless the control
turns it on.

The iteration (Alg. 4 and 5, four sparse hops): each MU's gradient g at its
cluster's model, the DGC step u <- σu + g, v <- v + u, ĝ = Ω(v, φ_MU^ul),
u and v cleared where ĝ is sent; the SBS averages ĝ over its MUs, steps
w - lr·ĝ_n, re-injects β_s·e_n and sends Ω(·, φ_SBS^dl) to its MUs.  Every
H iterations each SBS sends Ω((w_n - w_ref) + β_s·ε_n, φ_SBS^ul) up, the
MBS forms δ = Σ sent_n / N + β_m·e and sends Ω(δ, φ_MBS^dl) down, and each
SBS passes Ω((w_ref - w_n) + β_s·e_n, φ_SBS^dl) on to its MUs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from hflbench.reference.lm import named_leaves
from hflbench.reference.omega import omega_keep, select_topk

STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))
BN_EPS = 1e-5


def _same(size, k, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    kh, kw = w.shape[0], w.shape[1]
    (t, b), (l, r) = _same(x.shape[2], kh, stride), _same(x.shape[3], kw, stride)
    return F.conv2d(F.pad(x, (l, r, t, b)), w.permute(3, 2, 0, 1), stride=stride)


def _bn(p, x):
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    y = (x - mu) / torch.sqrt(var + BN_EPS)
    return y * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


def resnet18(p, x):
    """x [B, 32, 32, 3] -> logits [B, classes]."""
    h = torch.relu(_bn(p["bn0"], _conv(x.permute(0, 3, 1, 2), p["conv0"])))
    for si, (_, stride) in enumerate(STAGES):
        for bi in range(2):
            pre, st = f"s{si}b{bi}", (stride if bi == 0 else 1)
            y = torch.relu(_bn(p[pre + "bn1"], _conv(h, p[pre + "c1"], st)))
            y = _bn(p[pre + "bn2"], _conv(y, p[pre + "c2"]))
            idt = _bn(p[pre + "bnp"], _conv(h, p[pre + "proj"], st)) if pre + "proj" in p else h
            h = torch.relu(y + idt)
    return h.mean(dim=(2, 3)) @ p["fc_w"] + p["fc_b"]


def _tree(names, flat, shapes):
    out: dict = {}
    for name, part, shape in zip(names, flat.split([s.numel() for s in shapes]), shapes):
        d = out
        parts = name.split("/")
        for k in parts[:-1]:
            d = d.setdefault(k, {})
        d[parts[-1]] = part.view(shape)
    return out


def _keep(v, phi, rule):
    if rule == "hist":
        return omega_keep(v, phi)
    mask = torch.zeros(v.numel(), dtype=torch.bool, device=v.device)
    mask[select_topk(v, phi)] = True
    return mask


def _hop(x, phi, rule):
    keep = _keep(x, phi, rule)
    sent = torch.where(keep, x, torch.zeros_like(x))
    return sent, x - sent


def faithful_readings(w0, batches, hfl, steps, *, rule="hist", tf32=False):
    """Follow the first ``steps`` iterations from the ResNet-18 tree ``w0`` on
    ``batches[t]`` = (x [K, B, 32, 32, 3], y [K, B]).  -> readings: ``loss``
    [steps][1] (the MUs' mean), ``grad1`` {leaf: [N]} (the norm of each
    cluster's mean gradient in the first iteration), ``change`` {leaf: [N],
    "w_ref/"+leaf: [1]}."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _follow(w0, batches, hfl, steps, rule)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _follow(w0, batches, hfl, steps, rule):
    names, leaves = zip(*named_leaves(w0))
    shapes = [t.shape for t in leaves]
    sizes = [t.numel() for t in leaves]
    flat0 = torch.cat([t.reshape(-1).float() for t in leaves])
    N, M, H = hfl["clusters"], hfl["mus"], hfl["period"]
    K, Q = N * M, flat0.numel()
    phi, sigma, lr = hfl["phi"], hfl["momentum"], hfl["lr"]
    bs, bm = hfl["beta_s"], hfl["beta_m"]
    z = lambda *s: torch.zeros(s, device=flat0.device)
    w = flat0[None].repeat(N, 1)
    u, v, e_n, eps_n, e = z(K, Q), z(K, Q), z(N, Q), z(N, Q), z(Q)
    w_ref = flat0.clone()
    losses, grad1 = [], {}
    for t in range(steps):
        x, y = batches[t]
        ls = []
        gsum = z(N, Q) if t == 0 else None
        for n in range(N):
            ghat = torch.zeros(Q, device=flat0.device)
            for mu_ in range(M):
                k = n * M + mu_
                xk, yk = x[k], y[k]
                leaf = w[n].detach().clone().requires_grad_(True)
                with torch.enable_grad():
                    logits = resnet18(_tree(names, leaf, shapes), xk)
                    loss = -torch.log_softmax(logits, -1).gather(1, yk.long()[:, None]).mean()
                    (g,) = torch.autograd.grad(loss, leaf)
                ls.append(float(loss.detach()))
                with torch.no_grad():
                    if gsum is not None:
                        gsum[n] += g
                    u[k] = sigma * u[k] + g
                    v[k] += u[k]
                    keep = _keep(v[k], phi[0], rule)
                    ghat += torch.where(keep, v[k], torch.zeros_like(g))
                    u[k][keep] = 0.0
                    v[k][keep] = 0.0
            with torch.no_grad():
                ghat /= M
                step = (w[n] - lr * ghat + bs * e_n[n]) - w[n]
                sent, e_n[n] = _hop(step, phi[1], rule)
                w[n] += sent
        losses.append([sum(ls) / len(ls)])
        if t == 0:
            for n in range(N):
                for name, part in zip(names, gsum[n].split(sizes)):
                    grad1.setdefault(name, []).append(float(torch.linalg.vector_norm(part / M)))
        if (t + 1) % H == 0:
            with torch.no_grad():
                acc = torch.zeros(Q, device=flat0.device)
                for n in range(N):
                    sent, eps_n[n] = _hop((w[n] - w_ref) + bs * eps_n[n], phi[2], rule)
                    acc += sent
                d, e = _hop(acc / N + bm * e, phi[3], rule)
                w_ref += d
                for n in range(N):
                    sent, e_n[n] = _hop((w_ref - w[n]) + bs * e_n[n], phi[1], rule)
                    w[n] += sent
    change = {}
    for n in range(N):
        for name, part, p0 in zip(names, w[n].split(sizes), flat0.split(sizes)):
            change.setdefault(name, []).append(float(torch.linalg.vector_norm(part - p0)))
    for name, part, p0 in zip(names, w_ref.split(sizes), flat0.split(sizes)):
        change["w_ref/" + name] = [float(torch.linalg.vector_norm(part - p0))]
    return {"loss": losses, "grad1": grad1, "change": change}
