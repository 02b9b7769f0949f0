"""CUDA graphs of the S = 1 paged decode forward, one per read bucket.

The reference compiles its decode step once per static key and replays
the executable (skypilot_tpu/infer/engine.py `_dispatch_plain`'s
`decode_key`).  The port's counterpart captures the S = 1 paged slot
forward, `model.hidden` and `model.head` with the paged-decode kernel
(both branches) in every layer, in one CUDA graph per read bucket, and
replays it: one launch from the host where the eager forward makes
about 1500.

The graph reads four static input buffers, which every replay first
overwrites with the step's values (`DecodeGraphs.copied`): the feed
tokens [B, 1], their rope positions [B, 1], the kv mask [B, max_seq_len]
with the step's write slots revealed, and the row each logit is taken
at (`last_pos`, [B]).  The K/V pools, their scale pools and the block
table are the cache's own tensors, updated in place between steps, so
the graph reads them where they are.  Sampling stays outside the graph
(it runs before the replay, eagerly, with its per-row generators): the
reference keys its executable by sampling's static arguments too, the
port by the read bucket alone.

A capture first runs the forward twice on the graphs' own stream with
the step's inputs (it rewrites the same K/V the step writes): that
builds the kernel at first use, sets its shared-memory attribute, and
allocates the kernel's per-stream scratch and cuBLAS's workspace
outside the capture.  The graphs share one memory pool: they replay one
at a time, on one stream.  A capture that fails raises; nothing falls
back to the eager forward.

Launch counts: a replay launches the kernels captured in it without
calling their wrappers, so the wrappers' counts are taken back after a
capture (which launches nothing) and added once per replay
(`paged_attention.add_launches`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import torch

from skypilot_tpu_torch.ops import paged_attention as pa


@dataclasses.dataclass
class _Graph:
    graph: Any                     # torch.cuda.CUDAGraph
    logits: torch.Tensor           # the graph's output [B, V] f32
    launches: Dict[str, Dict[int, int]]   # kernel 4 launches in it, by S
    scratch: List[torch.Tensor]    # the kernel's scratch it captured


class DecodeGraphs:
    """The captured S = 1 paged decode forwards of one engine's model and
    cache, by read bucket, captured at first use."""

    # The static inputs a replay overwrites (a test leaves one out to
    # plant a stale graph input).
    copied = ('feed', 'positions', 'kv_mask', 'last_pos')

    def __init__(self, model: Any, cache: Any) -> None:
        self.model = model
        self.cache = cache
        self._graphs: Dict[int, _Graph] = {}
        self._static: Dict[str, torch.Tensor] = {}
        self._stream = None
        self._pool = None
        self.capture_s = 0.0        # wall seconds of every capture
        self.pool_bytes = 0         # device memory reserved by captures
        self.replays = 0

    def _forward(self, bucket: int) -> torch.Tensor:
        st = self._static
        x = self.model.hidden(st['feed'], st['positions'], self.cache,
                              st['kv_mask'], kernel='fused',
                              read_len=bucket)
        return self.model.head(x[st['rows'], st['last_pos']])

    def _capture(self, bucket: int) -> _Graph:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        if self._stream is None:
            self._stream = torch.cuda.Stream()
            self._pool = torch.cuda.graph_pool_handle()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(2):
                self._forward(bucket)
        torch.cuda.current_stream().wait_stream(stream)
        before = pa.launches_by_branch()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=stream):
            logits = self._forward(bucket)
        after = pa.launches_by_branch()
        launches = {branch: {s: n - before[branch].get(s, 0)
                             for s, n in counts.items()
                             if n != before[branch].get(s, 0)}
                    for branch, counts in after.items()}
        # The capture launched nothing.
        pa.add_launches({branch: {s: -n for s, n in counts.items()}
                         for branch, counts in launches.items()})
        entry = _Graph(graph, logits, launches,
                       pa.scratch(logits.device, stream.cuda_stream))
        self._graphs[bucket] = entry
        # What stays reserved once the warm-up's blocks are released: the
        # pool's segments (and the kernel's scratch on the graphs' stream).
        torch.cuda.empty_cache()
        self.pool_bytes += torch.cuda.memory_reserved() - reserved
        self.capture_s += time.perf_counter() - t0
        return entry

    def run(self, bucket: int, **inputs: torch.Tensor) -> torch.Tensor:
        """The logits [B, V] of one S = 1 forward at read bucket `bucket`
        on `inputs` (feed, positions, kv_mask, last_pos), replayed from
        the bucket's graph (captured now if this is its first step)."""
        if not self._static:
            self._static = {name: torch.zeros_like(t)
                            for name, t in inputs.items()}
            self._static['rows'] = torch.arange(
                inputs['feed'].shape[0], device=inputs['feed'].device)
        for name in self.copied:
            self._static[name].copy_(inputs[name])
        entry = self._graphs.get(bucket)
        if entry is None:
            entry = self._capture(bucket)
        entry.graph.replay()
        pa.add_launches(entry.launches)
        self.replays += 1
        return entry.logits.clone()

    def info(self) -> Dict[str, Any]:
        """What was captured: buckets, capture seconds, pool bytes and
        replays so far."""
        return dict(buckets=sorted(self._graphs), capture_s=self.capture_s,
                    pool_bytes=self.pool_bytes, replays=self.replays)
