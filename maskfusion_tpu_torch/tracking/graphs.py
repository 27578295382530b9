"""CUDA graphs of the tracking solve.

The Gauss-Newton solve (tracking/odometry) issues a fixed schedule of small
operations: about 6.5k launches for the global VGA track and 7.2k for two
windowed object slots.  None of them waits on the device.  Every shape
follows from the configuration and the slot count, a converged iteration
keeps its state through ``torch.where``, and the 6x6 solves report failure
in device tensors.  So the chain is captured once as a CUDA graph for each
signature of its inputs and replayed after that: one graph launch in place
of thousands of eager ones.

``SolveGraphs.run(key, fn, inputs)`` keeps one graph a key.  A key
(``graph_key``) holds the Python values the captured kernels bake in and
each input's signature: a tensor's shape, dtype and device; a host int
by its type, never its value (the int becomes a 0-d int32 device tensor,
filled on each call); None as None.  On the first sight of a key it runs
``fn`` once eagerly on a side stream, so that the cuBLAS and cuSOLVER
handles, their workspaces and the solve's cached constants exist before
the capture.  It then captures ``fn`` on static copies of the inputs, with
the float32 outputs flattened into one buffer inside the graph.  Each call
copies its inputs into the static buffers, replays, and returns views of
ONE clone of that buffer: nothing returned aliases the graphs' memory.

The graphs of one device share one memory pool: a later capture reuses
what an earlier graph frees at its end.  So a replay may overwrite
another graph's intermediates and even its output buffer.  That is safe
because replays are issued one after another on the calling stream, and
each output buffer is cloned right after its own replay, before any other
replay runs: no graph reads a pool value that an earlier replay left.

The capture neither synchronises nor empties the allocator's cache (as
``torch.cuda.graph`` does), so a frame that meets a new shape still issues
no synchronising call.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch


def signature(x):
    """What a graph bakes in of one input: a tensor's shape, dtype and
    device; of a host int, its type alone; None."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if x is None or isinstance(x, int):
        return None if x is None else int
    raise TypeError(f"a graphed input is a tensor, an int or None, "
                    f"not {type(x).__name__}")


def graph_key(static: tuple, inputs: Sequence) -> tuple:
    """The cache key of a call: ``static`` and each input's signature.
    The matmul precision settings are read at capture, so they key too."""
    return (static, torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision(),
            tuple(signature(x) for x in inputs))


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    static: List            # the captured inputs' buffers (None for None)
    flat: torch.Tensor      # every output, flattened, in the device's pool
    shapes: List[torch.Size]
    pool_bytes: int         # what the capture added to the reserve
    keep: tuple             # constants the captured kernels read


def _static_copy(x, dev: torch.device):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if x is None:
        return None
    return torch.full((), x, dtype=torch.int32, device=dev)


class SolveGraphs:
    """The graphs of one engine's solves, one a key."""

    def __init__(self):
        self._graphs: Dict[tuple, _Graph] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._pools: Dict[torch.device, tuple] = {}   # one pool a device

    def __len__(self) -> int:
        return len(self._graphs)

    @property
    def pool_bytes(self) -> int:
        """The memory the graphs' pools reserve, in all: what the
        allocator's reserve grew by across the captures."""
        return sum(g.pool_bytes for g in self._graphs.values())

    def run(self, key: tuple, fn: Callable, inputs: Sequence,
            keep: Callable[[], tuple] = tuple
            ) -> Tuple[List[torch.Tensor], bool]:
        """``fn(*inputs)`` as the replay of the graph of ``key``
        (``graph_key`` of the inputs), captured first if the key is new:
        (the outputs, whether this call captured).
        ``keep()``, called at a capture, gives what the captured kernels
        read besides the inputs (cached constants), which the graph then
        holds alive."""
        g = self._graphs.get(key)
        captured = g is None
        if captured:
            g = self._graphs[key] = self._capture(fn, inputs, keep)
        else:
            for buf, x in zip(g.static, inputs):
                if isinstance(x, torch.Tensor):
                    buf.copy_(x)
                elif x is not None:
                    buf.fill_(x)
        g.graph.replay()
        flat = g.flat.clone()
        out, at = [], 0
        for s in g.shapes:
            n = s.numel()
            out.append(flat[at:at + n].view(s))
            at += n
        return out, captured

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
            fn(*static)                    # the warm-up, eager
            reserved = torch.cuda.memory_reserved(dev)
            graph.capture_begin(pool=self._pools.get(dev),
                                capture_error_mode="thread_local")
            try:
                outs = fn(*static)
                if any(o.dtype != torch.float32 for o in outs):
                    raise TypeError("a graphed solve returns float32 "
                                    "tensors")
                flat = torch.cat([o.reshape(-1) for o in outs])
            finally:
                graph.capture_end()
        current.wait_stream(side)
        self._pools.setdefault(dev, graph.pool())
        return _Graph(graph, static, flat, [o.shape for o in outs],
                      torch.cuda.memory_reserved(dev) - reserved, keep())
