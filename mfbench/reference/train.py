"""The plain reference of the Mask R-CNN training step, and the comparison
that decides the training cell's ``correct``.

The reference is the frozen copy of the network (``maskrcnn.py``) computing
in float32 with TF32 off, one image at a time (each image's loss over the
batch size, its gradient accumulated: the gradient of the batch mean), and
Adam as optax computes it.  It starts from the weights the benchmark made
and takes the batches and proposal draws the benchmark handed the program.
With ``fp8`` it is the control: every multiply-accumulate layer computes
in bfloat16 on operands rounded to fp8.

The proposals are where the reference follows the program: the RPN's top
scores are sorted and suppressed, so a rounding in the RPN reorders near
ties and the two sides would sample other rois and heads' gradients from
then on.  The reference therefore takes the program's proposals for the
heads, and the stage it skips is checked by itself: the RPN's outputs
against the reference's on the first step (``rpn_gap``), and the
reference's proposal stage run on the program's RPN outputs against the
program's proposals (``proposal_flips``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from mfbench.reference import maskrcnn as mm

B1, B2, EPS = 0.9, 0.999, 1e-8


def network_config(net: Dict, dtype) -> mm.MaskRCNNConfig:
    """The reference's config from the configuration file's ``network``
    group, computing in ``dtype``."""
    fields = {f.name for f in dataclasses.fields(mm.MaskRCNNConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in net.items() if k in fields and k != "dtype"}
    return mm.MaskRCNNConfig(dtype=dtype, **kw)


def build(net: Dict, weights: Dict[str, torch.Tensor], fp8: bool = False,
          device="cuda") -> mm.MaskRCNN:
    model = mm.MaskRCNN(network_config(
        net, torch.bfloat16 if fp8 else torch.float32)).to(device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    if fp8:
        for mod in model.modules():
            if isinstance(mod, (mm.Conv, mm.Dense, mm.ConvTranspose2x2)):
                mod.fp8 = True
    return model


def run_steps(model: mm.MaskRCNN, batches: Sequence[Dict], draws: Sequence,
              lr: float, proposals: Sequence) -> Dict:
    """One Adam step a batch, the heads on ``proposals`` (a step, an image:
    the program's (boxes, valid)).  Returns each step's mean loss, the
    first step's gradient a parameter, each parameter's change after the
    last step (norms, by name), and the first step's RPN outputs and loss
    an image."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = dict(model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        m = {n: torch.zeros_like(p) for n, p in params.items()}
        v = {n: torch.zeros_like(p) for n, p in params.items()}
        losses: List[float] = []
        grad1 = {}
        rpn1, image1 = [], []
        at = [0, 0]                     # (step, image) being computed

        def program_proposals(logits, deltas):
            t, b = at
            if t == 0:
                rpn1.append((logits, deltas))
            if b < len(proposals[t]):
                return proposals[t][b]
            # an image the program left out: the reference's own proposals
            return mm.MaskRCNN._proposals(model, logits, deltas)

        model._proposals = program_proposals
        for t, (batch, d) in enumerate(zip(batches, draws), start=1):
            for p in params.values():
                p.grad = None
            B = batch["images"].shape[0]
            total = 0.0
            for b in range(B):
                at[:] = [t - 1, b]
                out = model.train_losses(
                    batch["images"][b][None], batch["gt_boxes"][b],
                    batch["gt_classes"][b], batch["gt_valid"][b],
                    batch["gt_masks"][b], d[b])
                if t == 1:
                    image1.append(float(out["total"].detach()))
                loss = out["total"] / B
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            with torch.no_grad():
                for n, p in params.items():
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    if t == 1:
                        grad1[n] = g.clone()
                    m[n].mul_(B1).add_(g, alpha=1 - B1)
                    v[n].mul_(B2).addcmul_(g, g, value=1 - B2)
                    mhat = m[n] / (1 - B1 ** t)
                    vhat = v[n] / (1 - B2 ** t)
                    p.sub_(lr * mhat / (torch.sqrt(vhat) + EPS))
        change = {n: float(torch.linalg.vector_norm(p.detach() - start[n]))
                  for n, p in params.items()}
        return {"losses": losses, "grads": grad1, "change_norms": change,
                "rpn": rpn1, "image_losses": image1}
    finally:
        del model._proposals
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names) -> Dict[str, float]:
    """Each leaf's gap between the two norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = _median([ref[n] for n in names])
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def norms(grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}


def moved_leaves(ref: Dict) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others (a key's bias under softmax, say) move under
    Adam by round-off alone."""
    g = norms(ref["grads"])
    med = _median(list(g.values()))
    return sorted(n for n, v in g.items() if v >= 1e-3 * med)


def grad_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The first gradient against the reference's, over the moved leaves:
    each leaf's gap of norms against the larger of its reference norm and
    the median leaf's (``grad_gap`` the worst leaf, ``grad_gap_median``
    the median leaf); the whole gradient's gap of norms
    (``grad_norm_gap``); and the norm of the difference, the median leaf's
    against the same scale (``grad_diff_median``) and the whole
    gradient's against its norm (``grad_diff``)."""
    names = moved_leaves(ref)
    gp, gr = prog["grads"], ref["grads"]
    np_, nr = norms({n: gp[n] for n in names}), norms({n: gr[n] for n in
                                                      names})
    med = _median(list(nr.values()))
    gaps = leaf_gaps(np_, nr, names)
    diffs = {n: float(torch.linalg.vector_norm(gp[n].float() - gr[n]))
             for n in names}
    tot_p = sum(v * v for v in np_.values()) ** 0.5
    tot_r = sum(v * v for v in nr.values()) ** 0.5
    tot_d = sum(v * v for v in diffs.values()) ** 0.5
    return {"grad_gap": max(gaps.values()),
            "grad_gap_median": _median(list(gaps.values())),
            "grad_norm_gap": abs(tot_p - tot_r) / tot_r,
            "grad_diff_median": _median([diffs[n] / max(nr[n], med, 1e-30)
                                         for n in names]),
            "grad_diff": tot_d / tot_r}


def detail(prog: Dict, ref: Dict, top: int = 4) -> Dict:
    """The worst leaves of the gradient and the change, and the median
    leaf's gaps: what to look at when a gap reads high."""
    names = moved_leaves(ref)
    out = {}
    for key in ("grads", "change_norms"):
        a, b = prog[key], ref[key]
        if key == "grads":
            a, b = norms(a), norms(b)
        g = leaf_gaps(a, b, names)
        worst = sorted(g.items(), key=lambda kv: -kv[1])[:top]
        out[key] = {"median_gap": _median(list(g.values())),
                    "worst": [[n, v, a[n], b[n]] for n, v in worst]}
    out["losses"] = [prog["losses"], ref["losses"]]
    out["image_losses"] = [prog["image_losses"], ref["image_losses"]]
    return out


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def proposal_flips(model: mm.MaskRCNN, prog_rpn, prog_props) -> int:
    """Proposals (box or validity) of the program that the reference's
    proposal stage, run on the program's RPN outputs, does not give."""
    flips = 0
    with torch.no_grad():
        for (logits, deltas), (boxes, valid) in zip(prog_rpn, prog_props):
            b, v = mm.MaskRCNN._proposals(model, logits, deltas)
            flips += int(((b != boxes).any(-1) | (v != valid)).sum())
    return flips


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers the training cell computes (its workload file's limits
    say which it compares):

    - ``image_loss_gap``: each image's loss in the first step, the largest
      relative gap (an image the program left out reads infinite);
    - ``batch_loss_gap``: the first step's batch loss that the step
      returned, against the mean of the reference's image losses;
    - ``update_gap``: the parameters' change after the compared steps, the
      worst moved leaf's gap (``moved_leaves``);
    - the first gradient, as Adam took it, by ``grad_numbers``;
    - ``rpn_gap``: the first step's RPN logits and deltas, the largest gap
      against the reference's largest magnitude.

    ``detail`` gives besides the later steps' losses (they part company by
    Adam's first updates, about lr x sign(g), whose sign rounding flips on
    the smallest gradients) and the worst leaves (the first blocks'
    GroupNorm scales and biases, whose gradients sum over every pixel with
    much cancellation and amplify bfloat16's rounding)."""
    want = ref["image_losses"]
    got = prog["image_losses"]
    image_loss_gap = float("inf") if len(got) != len(want) else max(
        abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))
    batch_loss_gap = abs(prog["losses"][0] - ref["losses"][0]) / max(
        abs(ref["losses"][0]), 1e-30)
    names = moved_leaves(ref)
    update_gap = max(leaf_gaps(prog["change_norms"], ref["change_norms"],
                               names).values())
    rpn_gap = max(max(rel_gap(a[0], b[0]), rel_gap(a[1], b[1]))
                  for a, b in zip(prog["rpn"], ref["rpn"]))
    return dict(grad_numbers(prog, ref), image_loss_gap=image_loss_gap,
                batch_loss_gap=batch_loss_gap, update_gap=update_gap,
                rpn_gap=rpn_gap)
