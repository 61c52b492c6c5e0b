"""The reference's first training steps: for each step, the masked mean
cross-entropy of the model (``reference/<model>.py``) over that step's
sample, its gradient by autograd, and Adam written out (torch's default
betas and eps). Returns what ``check.py`` compares: each step's loss, the
first step's gradient, and the weights after the last step."""

from __future__ import annotations

import importlib

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def model(cfg: dict):
    return importlib.import_module(f"gnnbench.reference.{cfg['model']}")


def steps(cfg: dict, weights: dict, refs_list, features: torch.Tensor,
          labels_list, dtype: torch.dtype, *, tf32: bool = False,
          keep: float = 1.0) -> dict:
    """``weights`` the initial weights, ``refs_list`` and ``labels_list``
    (the graph's labels of each step's targets) one a step, all on one
    device. ``dtype`` is the reference's precision; ``tf32`` lets its
    float32 products run in TF32 (the control); ``keep`` < 1 leaves out
    all but that share of each step's targets and takes the mean over the
    rest (a planted fault). Returns ``{"losses": [float], "grad1":
    {name: tensor}, "final": {name: tensor}}``."""
    fwd = model(cfg).forward
    lr = float(cfg["lr"])
    params = {k: v.detach().to(features.device, dtype).clone()
              .requires_grad_(True) for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    feats = features.to(dtype)
    out = {"losses": [], "grad1": None}
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for t, (refs, labels) in enumerate(zip(refs_list, labels_list), 1):
            logits = fwd(params, refs, feats, cfg)
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
            n = labels.numel()
            if keep < 1.0:
                nll = nll[: max(int(n * keep), 1)]
            loss = nll.mean()
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            out["losses"].append(float(loss.detach()))
            with torch.no_grad():
                grads = {k: (g if g is not None else torch.zeros_like(p))
                         for (k, p), g in zip(params.items(), grads)}
                if t == 1:
                    out["grad1"] = {k: g.clone() for k, g in grads.items()}
                c1, c2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
                for k, p in params.items():
                    g = grads[k]
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    denom = (v2[k].sqrt() / c2 ** 0.5).add_(EPS)
                    p.addcdiv_(m[k], denom, value=-lr / c1)
            del logits, logp, nll, loss, grads
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
    out["final"] = {k: p.detach() for k, p in params.items()}
    return out
