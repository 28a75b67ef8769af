"""The numbers that decide `correct`: each compares what the program
produced with what the reference produced from the same inputs. Every
number is a gap (0 is agreement) and is held against a limit of its own
(`benchmark/limits/<cell>.json`).

Training (the takeover and pretraining cells), by the worst leaf: the gap
between the program's norm and the reference's, measured against the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone under Adam (eps 1e-15 turns any non-zero
gradient into a step of the learning rate); they are left out of the
change, by that rule on the reference's gradient, never by name.
"""

from __future__ import annotations

import math
import statistics

import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of the change
ROUNDING_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def loss_gap(program: list, reference: list) -> float:
    """The largest relative gap of one step's loss."""
    return max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-12) for a, b in zip(program, reference))


def leaf_gap(program: dict, reference: dict, keep=None) -> tuple[float, str]:
    """(the worst leaf's gap of norms, its name) over the leaves in `keep`
    (all when None)."""
    names = [k for k in reference if keep is None or k in keep]
    norms = {k: _norm(reference[k]) for k in names}
    med = statistics.median(norms.values())
    worst = (0.0, "")
    for k in names:
        g = abs(_norm(program[k]) - norms[k]) / max(norms[k], med, 1e-30)
        worst = max(worst, (g, k))
    return worst


def moving_leaves(reference_grads: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding."""
    norms = {k: _norm(v) for k, v in reference_grads.items()}
    med = statistics.median(norms.values())
    return {k for k, n in norms.items() if n >= ROUNDING_LEAF * med and n > 0.0}


def training_numbers(program: dict, reference: dict) -> dict:
    """loss_gap over the followed steps, grad_gap of the first gradient and
    change_gap of the parameters' change over the followed steps, each by
    the worst leaf, and the same two for each moving leaf alone
    (`grad_gap.<leaf>`, `change_gap.<leaf>`, against that leaf's reference
    norm). Each side: {"losses": [...], "grads": {leaf: tensor}, "before":
    {leaf: tensor}, "after": {leaf: tensor}}."""
    keep = moving_leaves(reference["grads"])
    change = {side: {k: s["after"][k] - s["before"][k] for k in keep} for side, s in
              (("p", program), ("r", reference))}
    grad, grad_leaf = leaf_gap(program["grads"], reference["grads"], keep)
    ch, ch_leaf = leaf_gap(change["p"], change["r"])
    out = {"loss_gap": loss_gap(program["losses"], reference["losses"]), "grad_gap": grad, "change_gap": ch,
           "_worst": {"grad_gap": grad_leaf, "change_gap": ch_leaf}, "_kept": sorted(keep)}
    for k in sorted(keep):
        out[f"grad_gap.{k}"] = leaf_gap({k: program["grads"][k]}, {k: reference["grads"][k]})[0]
        out[f"change_gap.{k}"] = leaf_gap({k: change["p"][k]}, {k: change["r"][k]})[0]
    return out


def image_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """Relative L1 of an image: sum |p - r| / sum |r|."""
    p, r = program.double(), reference.double()
    return float(torch.sum(torch.abs(p - r)) / torch.clamp(torch.sum(torch.abs(r)), min=1e-30))


def emitter_numbers(records: list, fn_of) -> dict:
    """The emitter calls of one step (`drivers/takeover.EmitterTap`)
    answered again by the reference's query `fn_of(camera_index=...)` at the
    same rays, over the rays whose x and d are finite (a ray that misses the
    surface has no hit point: the renderer masks its secondary query out):

    - `emitter_gap`: the radiance's relative L1, sum |p - r| / sum |r|;
    - `emitter_ray_gap`: the median over the rays of each ray's relative
      L1, sum |p - r| / sum |r| over its colours (the denominator floored at
      a thousandth of the median ray's);
    - `emitter_vjp_gap`: the emitter's backward, given the gradient that
      reached the program's radiance: for x and for d, ||G_p - G_r|| /
      ||G_r|| over every ray that carries a gradient, the larger of the two
      (a backward that returns zeros, or none, reads 1);
    - `emitter_vjp_norm_gap`: the same with the gap of the two norms,
      |‖G_p‖ - ‖G_r‖| / ‖G_r‖;
    - `emitter_vjp_top50_share`: the share of ||G_r||^2 that the 50
      largest rays carry (how far a few rays make the gap);
    - `emitter_nonfinite`: how many radiances and ray gradients the program
      gave as non-finite where the reference's are finite (compared
      exactly: its limit is 0); the gaps above are over the rest, and
      `emitter_ref_nonfinite` counts where the reference's are not finite;
    - `emitter_rays`, `emitter_grad_rays`, `emitter_skipped_rays`: how
      many rays that covers, and how many had no finite x or d (a call
      whose radiance took no gradient back is left out of the backward's
      numbers)."""
    num = den = 0.0
    per_ray = {k: ([], [], []) for k in ("x", "d")}  # |G_p - G_r|^2, |G_r|^2, |G_p|^2 per ray
    ray_err, ray_mag = [], []  # per ray: sum |p - r| and sum |r| over the colours
    rays = grad_rays = skipped = bad = ref_bad = 0
    missing = False
    for rec in records:
        ok = torch.isfinite(rec["x"]).all(dim=-1) & torch.isfinite(rec["d"]).all(dim=-1)
        skipped += int((~ok).sum())
        x = rec["x"][ok].clone().requires_grad_("x" in rec["grad"])
        d = rec["d"][ok].clone().requires_grad_("d" in rec["grad"])
        with torch.enable_grad():
            out = fn_of(camera_index=rec["cam"])(x, d)
        p_out, r_out = rec["out"][ok].double(), out.detach().double()
        both = torch.isfinite(p_out).all(dim=-1) & torch.isfinite(r_out).all(dim=-1)
        bad += int((~torch.isfinite(p_out).all(dim=-1) & torch.isfinite(r_out).all(dim=-1)).sum())
        ref_bad += int((~torch.isfinite(r_out).all(dim=-1)).sum())
        err, mag = torch.sum(torch.abs(p_out[both] - r_out[both]), dim=-1), torch.sum(torch.abs(r_out[both]), dim=-1)
        num += float(err.sum())
        den += float(mag.sum())
        ray_err.append(err)
        ray_mag.append(mag)
        rays += x.shape[0]
        if not rec["grad"]:
            continue
        if "g_out" not in rec:
            # no gradient reached the radiance: unused by the loss, or, where
            # the radiance did not even require one, an emitter with no backward
            missing |= not rec["out_grad"]
            continue
        grad_rays += x.shape[0]
        wrt = [t for k, t in (("x", x), ("d", d)) if k in rec["grad"]]
        for k, g_r in zip(rec["grad"], torch.autograd.grad(out, wrt, rec["g_out"][ok], allow_unused=True)):
            g_r = torch.zeros_like(x) if g_r is None else g_r.detach().double()
            g_p = rec[f"g_{k}"][ok].double() if f"g_{k}" in rec else torch.zeros_like(g_r)
            fin_p, fin_r = torch.isfinite(g_p).all(dim=-1), torch.isfinite(g_r).all(dim=-1)
            bad += int((~fin_p & fin_r).sum())
            ref_bad += int((~fin_r).sum())
            g_p, g_r = g_p[fin_p & fin_r], g_r[fin_p & fin_r]
            for acc, t in zip(per_ray[k], (g_p - g_r, g_r, g_p)):
                acc.append(torch.sum(t * t, dim=-1))
    missing |= grad_rays == 0 and any(rec["grad"] for rec in records)
    gaps = {"diff": [], "norm": [], "top50": []}
    for k, lists in per_ray.items():
        if not lists[1]:
            continue
        dd, rr, pp = (torch.cat(t) for t in lists)
        r_sq = float(rr.sum())
        if r_sq == 0.0:
            continue
        gaps["diff"].append(math.sqrt(float(dd.sum()) / r_sq))
        gaps["norm"].append(abs(math.sqrt(float(pp.sum())) - math.sqrt(r_sq)) / math.sqrt(r_sq))
        gaps["top50"].append(float(torch.topk(rr, min(50, rr.numel())).values.sum()) / r_sq)

    def worst(v):  # the larger of x's and d's; NaN where either is NaN
        return float("nan") if any(math.isnan(a) for a in v) else max(v, default=0.0)

    err, mag = torch.cat(ray_err), torch.cat(ray_mag)
    rel = err / torch.clamp(mag, min=max(1e-3 * float(torch.median(mag)) if mag.numel() else 0.0, 1e-30))
    return {"emitter_gap": num / max(den, 1e-30),
            "emitter_ray_gap": float(torch.median(rel)) if rel.numel() else 0.0,
            "emitter_vjp_gap": 1.0 if missing else worst(gaps["diff"]),
            "emitter_vjp_norm_gap": 1.0 if missing else worst(gaps["norm"]),
            "emitter_vjp_top50_share": worst(gaps["top50"]),
            "emitter_nonfinite": bad, "emitter_ref_nonfinite": ref_bad,
            "emitter_rays": rays, "emitter_grad_rays": grad_rays, "emitter_skipped_rays": skipped}


def emitter_answers(records: list, fn_of) -> list:
    """The emitter calls `records` answered by `fn_of(camera_index=...)`
    in their place: the same rays, the same gradient reaching the radiance,
    and this query's radiance and backward (the control's answers)."""
    answers = []
    for rec in records:
        # the rays with finite x and d alone (emitter_numbers judges no
        # other): a per-tensor scale would carry one ray's NaN to them all
        ok = torch.isfinite(rec["x"]).all(dim=-1) & torch.isfinite(rec["d"]).all(dim=-1)
        new = {k: rec[k] for k in ("cam", "grad", "out_grad")}
        new["x"], new["d"] = rec["x"][ok], rec["d"][ok]
        x = new["x"].clone().requires_grad_("x" in rec["grad"])
        d = new["d"].clone().requires_grad_("d" in rec["grad"])
        with torch.enable_grad():
            out = fn_of(camera_index=rec["cam"])(x, d)
        new["out"] = out.detach()
        if rec["grad"] and "g_out" in rec:
            new["g_out"] = rec["g_out"][ok]
            wrt = [t for k, t in (("x", x), ("d", d)) if k in rec["grad"]]
            for k, g in zip(rec["grad"], torch.autograd.grad(out, wrt, new["g_out"], allow_unused=True)):
                new[f"g_{k}"] = torch.zeros_like(new[k]) if g is None else g.detach()
        answers.append(new)
    return answers


def mixture_loglik(points: torch.Tensor, weights: torch.Tensor, means, pis, stds) -> float:
    """The weighted mean log-density of points (N, 3) under the spherical
    Gaussian mixture (means (K, 3), mixture weights (K,), stds (K,)) that
    the guiding fits to them, in nats."""
    p, w = points.double(), weights.double()
    var = stds.double() ** 2
    d2 = torch.sum((p[:, None, :] - means.double()[None]) ** 2, dim=-1)
    log_n = -0.5 * (d2 / var[None] + 3.0 * torch.log(2.0 * math.pi * var[None]))
    pi = pis.double() / torch.clamp(torch.sum(pis.double()), min=1e-30)
    ll = torch.logsumexp(log_n + torch.log(torch.clamp(pi, min=1e-30))[None], dim=1)
    return float(torch.sum(w * ll) / torch.clamp(torch.sum(w), min=1e-30))
