"""CUDA graphs of the engine's fixed chains of small operations.

Two chains of the SLAM frame issue a fixed schedule of small operations
that never waits on the device: the Gauss-Newton tracking solve
(tracking/odometry; about 6.5k launches for the global VGA track and 7.2k
for two windowed object slots) and each model's fuse, clean and predict
(engine.fuse_clean_predict and fuse_clean_predict_obj_win; about 2,000-
2,600 launches a model).  Every shape follows from the configuration, the
slot count, the bucket and the window; a converged iteration keeps its
state through ``torch.where``, the 6x6 solves report failure in device
tensors, and the map's live count stays on the device.  So each chain is
captured once as a CUDA graph for each signature of its inputs and
replayed after that: one graph launch in place of thousands of eager ones.

``SolveGraphs.run(key, fn, inputs)`` keeps one graph a key.  A key
(``graph_key``) holds the Python values the captured kernels bake in and
each input's signature: a tensor's shape, dtype and device; a host int or
float by its type, never its value (it becomes a 0-d int32 or float32
device tensor, filled on each call); None as None.  On the first sight of
a key it runs ``fn`` once eagerly on a side stream, so that the cuBLAS and
cuSOLVER handles, their workspaces and the chain's cached constants exist
before the capture.  It then captures ``fn`` on static copies of the
inputs, with the outputs, of any dtype, flattened into one byte buffer
inside the graph.  Each call copies its inputs into the static buffers,
replays, copies back the inputs that ``fn`` updates in place (``inout``:
the fuse's map prefix), and returns views of ONE clone of the output
buffer: nothing returned aliases the graphs' memory.  Host-side records
of the captured work (the scan's ``scan_live`` counter, the kernels'
launch counts) are taken by each replay (utils/stopwatch ``noting``).

The graphs of one device share one memory pool, across every runner made
with ``share`` too: a later capture reuses what an earlier graph frees at
its end.  So a replay may overwrite another graph's intermediates and even
its output buffer.  That is safe because replays are issued one after
another on the calling stream, and each output buffer is cloned right
after its own replay, before any other replay runs: no graph reads a pool
value that an earlier replay left.  The static buffers are not in the
pool.

The capture neither synchronises nor empties the allocator's cache (as
``torch.cuda.graph`` does), so a frame that meets a new shape still issues
no synchronising call.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch

from maskfusion_tpu_torch.utils import stopwatch


def signature(x):
    """What a graph bakes in of one input: a tensor's shape, dtype and
    device; of a host int or float, its type alone; None."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if x is None:
        return None
    if isinstance(x, float):
        return float
    if isinstance(x, int):
        return int
    raise TypeError(f"a graphed input is a tensor, an int, a float or "
                    f"None, not {type(x).__name__}")


def graph_key(static: tuple, inputs: Sequence) -> tuple:
    """The cache key of a call: ``static`` and each input's signature.
    The matmul precision and deterministic-algorithm settings are read at
    capture, so they key too."""
    return (static, torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision(),
            torch.are_deterministic_algorithms_enabled(),
            tuple(signature(x) for x in inputs))


def flatten(outs: Sequence[torch.Tensor]
            ) -> Tuple[torch.Tensor, List[tuple]]:
    """The tensors as ONE uint8 buffer, and the layout that undoes it:
    each tensor's (byte offset, bytes, shape, dtype).  The tensors of one
    dtype are joined first (whatever their strides), the widest elements
    first, so every tensor's bytes start aligned to its element size."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, o in enumerate(outs):
        groups.setdefault(o.dtype, []).append(i)
    parts, layout, at = [], [None] * len(outs), 0
    for dtype, idx in sorted(groups.items(),
                             key=lambda g: -outs[g[1][0]].element_size()):
        size = outs[idx[0]].element_size()
        for i in idx:
            layout[i] = (at, outs[i].numel() * size, outs[i].shape, dtype)
            at += outs[i].numel() * size
        parts.append(torch.cat([outs[i].reshape(-1) for i in idx])
                     .view(torch.uint8))
    return (parts[0] if len(parts) == 1 else torch.cat(parts)), layout


def unflatten(flat: torch.Tensor, layout: Sequence[tuple]
              ) -> List[torch.Tensor]:
    """Views of ``flat`` as the tensors of ``layout`` (``flatten``)."""
    out = []
    for at, n, shape, dtype in layout:
        out.append(flat[at:at + n].view(dtype).view(shape))
    return out


def _traced(fn: Callable, static: Sequence):
    """``fn(*static)`` with the host-side records it notes (utils/stopwatch
    ``noting``): the outputs and the noted records' device tensors as one
    flat buffer, its layout, and each record's (action, names, first index
    in the layout)."""
    with stopwatch.noting() as noted:
        outs = list(fn(*static))
    marks = []
    for action, tensors in noted:
        marks.append((action, list(tensors), len(outs)))
        outs.extend(tensors.values())
    flat, layout = flatten(outs)
    return flat, layout, tuple(marks)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    static: List            # the captured inputs' buffers (None for None)
    flat: torch.Tensor      # every output's bytes, in the device's pool
    layout: List[tuple]     # the outputs', then the noted tensors'
    pool_bytes: int         # what the capture added to the reserve
    keep: tuple             # constants the captured kernels read
    # (action, names, first index in layout) of each record noted at the
    # capture; the returned outputs are the layout's first entries
    noted: tuple = ()


def _static_copy(x, dev: torch.device):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if x is None:
        return None
    dtype = torch.float32 if isinstance(x, float) else torch.int32
    return torch.full((), x, dtype=dtype, device=dev)


class SolveGraphs:
    """The graphs of one engine's chain, one a key.  ``share``: another
    runner whose side streams and memory pools this one uses."""

    def __init__(self, share: Optional["SolveGraphs"] = None):
        self._graphs: Dict[tuple, _Graph] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = (
            share._streams if share is not None else {})
        # one pool a device
        self._pools: Dict[torch.device, tuple] = (
            share._pools if share is not None else {})

    def __len__(self) -> int:
        return len(self._graphs)

    @property
    def pool_bytes(self) -> int:
        """The memory this runner's graphs reserve, in all: what the
        allocator's reserve grew by across their captures."""
        return sum(g.pool_bytes for g in self._graphs.values())

    def run(self, key: tuple, fn: Callable, inputs: Sequence,
            keep: Callable[[], tuple] = tuple, inout: Sequence[int] = ()
            ) -> Tuple[List[torch.Tensor], bool]:
        """``fn(*inputs)`` as the replay of the graph of ``key``
        (``graph_key`` of the inputs), captured first if the key is new:
        (the outputs, whether this call captured).  ``fn`` may update the
        tensor inputs listed in ``inout`` in place; the call then updates
        them as ``fn`` would.  ``keep()``, called at a capture, gives what
        the captured kernels read besides the inputs (cached constants),
        which the graph then holds alive."""
        g = self._graphs.get(key)
        captured = g is None
        if captured:
            g = self._graphs[key] = self._capture(fn, inputs, keep)
        # every call, a capturing one too: the warm-up ran on the buffers
        for buf, x in zip(g.static, inputs):
            if isinstance(x, torch.Tensor):
                buf.copy_(x)
            elif x is not None:
                buf.fill_(x)
        g.graph.replay()
        for i in inout:
            inputs[i].copy_(g.static[i])
        out = unflatten(g.flat.clone(), g.layout)
        for action, names, first in g.noted:
            action(**dict(zip(names, out[first:first + len(names)])))
        return out[:g.noted[0][2] if g.noted else len(out)], captured

    def _capture(self, fn: Callable, inputs: Sequence,
                 keep: Callable[[], tuple]) -> _Graph:
        dev = next(x.device for x in inputs if isinstance(x, torch.Tensor))
        static = [_static_copy(x, dev) for x in inputs]
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            with stopwatch.warming_up():
                fn(*static)                # the warm-up, eager
            reserved = torch.cuda.memory_reserved(dev)
            graph.capture_begin(pool=self._pools.get(dev),
                                capture_error_mode="thread_local")
            try:
                flat, layout, marks = _traced(fn, static)
            finally:
                graph.capture_end()
        current.wait_stream(side)
        self._pools.setdefault(dev, graph.pool())
        return _Graph(graph, static, flat, layout,
                      torch.cuda.memory_reserved(dev) - reserved, keep(),
                      marks)
