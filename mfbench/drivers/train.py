"""The training driver: Mask R-CNN train steps through the program's
``parallel.train.create_train_step``.

Set-up makes the weights from the seed on the card (``traffic.weights``)
and loads them into the state that the program's ``init_fn`` builds (its
host initialisation is skipped: the benchmark's weights replace it), makes
a pool of batches on the card (``traffic.shapes``), counts the forward's
multiply-accumulates, and runs the first steps, which the reference
follows.  The window then runs steps on the pool in turn, each with fresh
proposal draws from a seeded device generator, until ``seconds`` have
passed, and ends with a synchronise.  ``train_images_per_s`` counts every
image of the window's steps over all of its time.

What decides ``correct`` (``reference.train.compare``; the workload
file's limits say which of its numbers are compared): each image's loss
in the first step and the batch loss the step returned, each parameter's
change after the compared steps and the first step's RPN outputs, against
the float32 reference fed the same weights, batches and draws, whose heads
run on the program's proposals; and the reference's proposal stage on the
program's RPN outputs against the program's proposals.  The first gradient
as Adam took it (its first moment after one step over 1 - b1) and the
later steps' losses are printed beside them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from typing import Dict, Optional

import torch

from mfbench import arith, harness
from mfbench.reference import maskrcnn as ref_mm
from mfbench.reference import train as ref_train
from mfbench.traffic import shapes, weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(net: Dict):
    from maskfusion_tpu_torch.maskrcnn.model import MaskRCNNConfig

    names = {f.name for f in dataclasses.fields(MaskRCNNConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in net.items() if k in names}
    kw["dtype"] = DTYPES[net["dtype"]]
    return MaskRCNNConfig(**kw)


@contextlib.contextmanager
def no_host_init():
    """``init_fn`` without its host initialisation of the weights."""
    from maskfusion_tpu_torch.parallel import train as ptrain

    saved = ptrain.init_params_
    ptrain.init_params_ = lambda model, seed=0: model
    try:
        yield
    finally:
        ptrain.init_params_ = saved


def seeded_weights(net: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        skeleton = ref_mm.MaskRCNN(ref_train.network_config(
            net, torch.float32))
    return weights.make_weights(skeleton, seed, device)


def program_side(model, w0: Dict[str, torch.Tensor], grad1: Dict):
    """The program's first gradient by parameter (``first_grads``) and each
    parameter's change since ``w0`` (norms, by name)."""
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p.detach() - w0[n]))
                  for n, p in model.named_parameters()}
    return {"grads": grad1, "change_norms": change}


def first_grads(model, opt) -> Dict[str, torch.Tensor]:
    """The gradient Adam took in its first step, parameter by parameter:
    its first moment over 1 - b1 (zero where it holds none)."""
    with torch.no_grad():
        grads = {}
        for n, p in model.named_parameters():
            m = opt.adam.state.get(p, {}).get("exp_avg")
            grads[n] = (torch.zeros_like(p) if m is None
                        else m / (1 - ref_train.B1))
    return grads


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device, t_start: float, control: Optional[str] = None
        ) -> harness.DriverResult:
    from maskfusion_tpu_torch.maskrcnn import model as mm
    from maskfusion_tpu_torch.parallel import train as ptrain

    wl, config = cell.workload, cell.config
    t = wl["traffic"]
    dev = torch.device(device)
    net = config["network"]
    cfg = program_config(net)
    B, lr = config["batch"], config["learning_rate"]
    G = t["max_instances"]
    spans = harness.Spans()

    w0 = seeded_weights(net, seed, dev)
    init_fn, step_fn = ptrain.create_train_step(cfg, lr, device=dev)
    with no_host_init():
        state = init_fn(0, B)
    with torch.no_grad():
        for n, p in state.params.named_parameters():
            p.copy_(w0[n])
    pool = shapes.make_pool(
        seed + 1, dev, t["pool_batches"], batch=B, size=cfg.image_size,
        max_instances=G, min_instances=t["min_instances"],
        num_classes=cfg.num_classes, min_side=t["min_side"],
        max_side=t["max_side"])
    gen = torch.Generator(device=dev).manual_seed(seed + 2)

    def draws():
        return torch.rand((B, 2, cfg.post_nms_proposals + G), generator=gen,
                          device=dev)

    def args(b):
        return (b["images"], b["gt_boxes"], b["gt_classes"], b["gt_valid"],
                b["gt_masks"])

    # the forward's multiply-accumulates, from the shapes the layers see
    d0 = draws()
    macs = arith.network_macs(
        state.params, lambda: state.params.batch_loss(*args(pool[0]), d0),
        (mm.Conv, mm.Dense, mm.ConvTranspose2x2))
    spans.counters["train_forward_macs"] = float(sum(macs.values()))

    # the compared steps, which also warm up every shape of the window;
    # the proposals each image's heads ran on are kept for the reference
    n_cmp = t["compared_steps"]
    cmp_draws, losses, grad1 = [], [], None
    kept = []
    model = state.params
    proposals = model._proposals

    def keep(logits, deltas):
        out = proposals(logits, deltas)
        kept.append((len(cmp_draws) - 1, (logits, deltas), out))
        return out

    losses_of = model.train_losses

    def keep_loss(*a, **kw):
        out = losses_of(*a, **kw)
        kept_losses.append((len(cmp_draws) - 1, out["total"].detach()))
        return out

    kept_losses = []
    model._proposals = keep
    model.train_losses = keep_loss
    try:
        for s in range(n_cmp):
            d = draws()
            cmp_draws.append(d)
            state, loss = step_fn(state, d, *args(pool[s % len(pool)]))
            losses.append(loss)
            if s == 0:
                grad1 = first_grads(state.params, state.opt_state)
    finally:
        del model._proposals, model.train_losses
    prog = program_side(state.params, w0, grad1)
    prog["losses"] = [float(x) for x in losses]
    prog["rpn"] = [k[1] for k in kept if k[0] == 0]
    prog["image_losses"] = [float(x) for s_, x in kept_losses if s_ == 0]
    prog_props = [[k[2] for k in kept if k[0] == s] for s in range(n_cmp)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    deadline = t0 + seconds
    steps = 0
    last = t0
    while True:
        b = pool[(n_cmp + steps) % len(pool)]
        state, _ = step_fn(state, draws(), *args(b))
        steps += 1
        now = time.perf_counter()
        spans.span("step", last, now)
        last = now
        if now >= deadline:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    harness.print_window(spans, "step", steps, window_s)
    profile = None
    if trace:
        k = n_cmp + steps
        batches = [(draws(), pool[(k + j) % len(pool)])
                   for j in range(t["trace_steps"])]

        def run_steps():
            nonlocal state
            for d, b in batches:
                state, _ = step_fn(state, d, *args(b))

        profile = harness.traced(run_steps, len(batches), dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, step_fn, init_fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    model = ref_train.build(net, w0, device=dev)
    flips = ref_train.proposal_flips(model, prog["rpn"], prog_props[0])
    ref = ref_train.run_steps(model, pool[:n_cmp], cmp_draws, lr, prog_props)
    del model
    values = ref_train.compare(prog, ref)
    values["proposal_flips"] = float(flips)
    print("train check numbers: " + json.dumps(values), file=sys.stderr)
    print("train check detail: " + json.dumps(ref_train.detail(prog, ref)),
          file=sys.stderr)
    ctrl = None
    if control == "fp8":
        # the control: the reference in fp8, in the program's place
        model = ref_train.build(net, w0, fp8=True, device=dev)
        low = ref_train.run_steps(model, pool[:n_cmp], cmp_draws, lr,
                                  prog_props)
        del model
        ctrl = ref_train.compare(low, ref)
        print("train control detail: " + json.dumps(
            ref_train.detail(low, ref)), file=sys.stderr)
    checks, ok = harness.judge(values, wl["limits"])
    return harness.DriverResult(
        e2e={"train_images_per_s": steps * B / window_s, "setup_s": setup_s},
        window_s=window_s, units=steps, spans=spans, profile=profile,
        checks=checks, correct=ok, attempted=steps, failed=0,
        memory_peak_bytes=peak, control=ctrl, values=values)
