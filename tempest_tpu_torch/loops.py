"""The device loops of an iteration: bodies in chunks, one host read a chunk.

JAX runs each loop of an iteration (the per-mode Student-t EM, the GMM EM,
the split rounds, the adaptive MCMC steps) as a `lax.while_loop` on the
device. Here a loop runs its bodies in chunks: a chunk is `length` bodies
back to back with no host read, and after it the host reads the loop's
exit predicate once (`LoopRun.read`). Every body freezes what has finished
(`torch.where` on a done flag, as a vmapped `while_loop` freezes its
finished lanes), so a chunk that runs past the exit changes nothing and
the result does not depend on the chunk length.

`Loops` holds the chunk length of each loop (`chunks`; 1 where absent,
which reads after every body) and, with `graphs=True` on a CUDA device,
runs each chunk as a `torch.cuda.CUDAGraph`:

- a loop's carry and its constants live in static buffers, one set per
  loop name and shapes; a loop entry copies its tensors into them, each
  replay updates the carry in place, and the loop's result is a copy of
  the carry (so the next entry may overwrite the buffers);
- a chunk of a given length is captured once, after one warm-up run of
  its bodies on the capture stream whose effects are undone (the
  registered generators' Philox offsets, the registered call counters and
  the kernels' launch counts are put back), and replayed from then on;
- the generators in `generators` are registered with every graph, so a
  replay draws what the eager bodies draw from the same offset and
  advances the offset as they would;
- `counters` holds the call counters of the Philox kernels
  (`cuda_prng.PhiloxCounter`), whose device words the captured bodies
  read and advance; a capture leaves each word where it was, and every
  replay advances it as the eager bodies would (the host mirror is read
  from the word only when asked for);
- a capture counts no kernel launch; every replay adds the launches its
  capture made (`launch_counts`), so a kernel's count stays its true
  number of launches;
- inside a straight-line stretch (`once`), `when` runs a body only where a
  0-d device bool is true: captured, it is a CUDA-graph conditional IF
  node (`ops.cuda_graphs`, the node `torch.cond` makes under a graph in
  later PyTorch releases), so a replay decides on the device and reads
  nothing. A replay skips the launches of an untaken node: each node's
  body adds one to a device word of its graph, and `launch_counts`
  (`settle_launches`) reads the words, the one read of the counting, only
  when the counts are asked for. A `once` inside a stretch runs inline,
  with no capture of its own; the stretch's warm-up runs every
  conditional body and keeps its results where the predicate holds
  (`torch.where`), so each body meets its libraries and kernel builds
  before the capture;
- `repeat` runs a body while a 0-d device bool of its carry holds, as
  `lax.while_loop` does: captured (a stretch of its own, or inside one), it
  is a CUDA-graph conditional WHILE node whose body runs on the device for
  as long as the predicate it recomputes holds, so a replay runs the whole
  loop and reads nothing; each run of the body adds one to its device word,
  which counts its launches and its runs (`stats[name]["node_bodies"]`, the
  runs of every conditional body of stretch `name`).
  Eagerly (graphs off, the CPU, a stretch's warm-up) it is a Python loop
  that reads the predicate after every body, so it runs the same bodies and
  launches the same kernels as the node;
- a capture that fails (a body that reads the host, such as a likelihood
  calling `.item()`, or synchronizes in a way PyTorch's sync check misses)
  raises `CaptureError` naming the cause and `on_device=False`, after the
  capture is abandoned without instantiating anything
  (`cuda_graphs.abort_capture`), so the process can go on and capture
  again; nothing falls back to eager execution.

A read copies the values with one non-blocking copy into pinned memory
and waits on an event: the chunk's one blocking host read. On the CPU
there are no graphs, and a read is a plain copy. `stats` counts, per loop,
the chunks, bodies, reads, captures and replays.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from collections import Counter, defaultdict
from typing import Callable, Dict, Iterator, List, Optional

import torch

from .ops import cuda_em, cuda_graphs, cuda_linalg, cuda_median, cuda_prng, cuda_reweight

Tensors = Dict[str, torch.Tensor]
Body = Callable[[Tensors, Tensors], Tensors]


class CaptureError(RuntimeError):
    """A loop chunk could not be captured as a CUDA graph."""


def _counts() -> Dict[str, int]:
    return {"ess_bisect": cuda_reweight.LAUNCHES, "ess_bisect_f64": cuda_reweight.LAUNCHES_F64,
            "ess_bracket": cuda_reweight.BRACKET_LAUNCHES, "sym_eigvals": cuda_linalg.LAUNCHES,
            "weighted_median": cuda_median.LAUNCHES, "set_conditional": cuda_graphs.LAUNCHES,
            **cuda_em.LAUNCHES, **cuda_prng.LAUNCHES}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count in this process, by kernel, the
    conditional bodies' launches of past replays included."""
    settle_launches()
    return _counts()


# Graphs whose replays ran conditional bodies not yet counted.
_UNSETTLED: "weakref.WeakSet[_Graph]" = weakref.WeakSet()


def settle_launches() -> None:
    """Add to the kernels' counts the launches of the conditional bodies
    that graph replays ran, from each graph's device words (one read a
    graph replayed since the last call), and set the words to 0."""
    for graph in list(_UNSETTLED):
        words, launches = graph.branches
        for taken, delta in zip(words.tolist(), launches):
            _add_launches({k: taken * v for k, v in delta.items()})
            graph.stats["node_bodies"] += taken
        words.zero_()
    _UNSETTLED.clear()


def _add_launches(delta: Dict[str, int], sign: int = 1) -> None:
    cuda_reweight.LAUNCHES += sign * delta["ess_bisect"]
    cuda_reweight.LAUNCHES_F64 += sign * delta["ess_bisect_f64"]
    cuda_reweight.BRACKET_LAUNCHES += sign * delta["ess_bracket"]
    cuda_linalg.LAUNCHES += sign * delta["sym_eigvals"]
    cuda_median.LAUNCHES += sign * delta["weighted_median"]
    cuda_graphs.LAUNCHES += sign * delta["set_conditional"]
    for counts in (cuda_em.LAUNCHES, cuda_prng.LAUNCHES):
        for name in counts:
            counts[name] += sign * delta[name]


def _signature(tensors: Tensors) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(tensors.items()))


class _Graph:
    """One captured chunk and the kernel launches its capture made outside
    conditional nodes; `outputs` holds the tensors a straight-line stretch
    returns; `branches`, where it has conditional nodes, their device words
    (one int64 each, the bodies run since the last `settle_launches`) and
    each body's launches; `stats`, its loop's or stretch's counters, which
    count the bodies' runs."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: Dict[str, int],
                 branches: Optional[tuple] = None, stats: Optional[Counter] = None):
        self.graph, self.launches = graph, launches
        self.branches, self.stats = branches, stats
        self.outputs: Tensors = {}
        # (top-level nodes, nodes in conditional bodies) where it has any,
        # and the seconds its capture and instantiation took
        self.nodes: Optional[tuple] = None
        self.capture_s = 0.0

    def replay(self) -> None:
        self.graph.replay()
        _add_launches(self.launches)
        if self.branches is not None:
            _UNSETTLED.add(self)


class Loops:
    """The loops of one sampler: chunk lengths, reads, and the graph cache."""

    def __init__(self, device, chunks: Optional[Dict[str, int]] = None, graphs: bool = False,
                 generators: Optional[List[torch.Generator]] = None,
                 counters: Optional[list] = None):
        self.device = torch.device(device)
        self.chunks = dict(chunks or {})
        self.graphs = graphs
        self.generators = list(generators or [])
        self.counters = list(counters or [])
        self.stats: Dict[str, Counter] = defaultdict(Counter)
        self._statics: Dict[tuple, tuple] = {}
        self._graphs: Dict[tuple, _Graph] = {}
        self._pinned: Optional[torch.Tensor] = None
        self._event = None
        self._stream = None
        # Inside a stretch: None, "warm-up" or "capture"; the conditional
        # bodies met, and during a capture their words and launches.
        self._stretch: Optional[str] = None
        self._branch_count = 0
        self._words: Optional[torch.Tensor] = None
        self._branches: List[Dict[str, int]] = []
        self._body_nodes = 0
        self._pool = None
        self._body_stream = None

    def chunk(self, name: str) -> int:
        """The bodies a chunk of loop `name` runs between its reads."""
        return self.chunks.get(name, 1)

    @property
    def graphed(self) -> bool:
        return self.graphs and self.device.type == "cuda"

    def read(self, name: str, *tensors: torch.Tensor) -> List[float]:
        """The values of `tensors` (flattened, in order) on the host: one
        blocking read, counted for loop `name`."""
        self.stats[name]["reads"] += 1
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
        if flat.device.type != "cuda":
            return flat.tolist()
        n = flat.numel()
        if self._pinned is None or self._pinned.numel() < n:
            self._pinned = torch.empty(max(n, 64), dtype=torch.float64, pin_memory=True)
            self._event = torch.cuda.Event()
        self._pinned[:n].copy_(flat, non_blocking=True)
        self._event.record()
        self._event.synchronize()
        return self._pinned[:n].tolist()

    def start(self, name: str, body: Body, carry: Tensors, consts: Tensors,
              static: tuple = ()) -> "LoopRun":
        """Enter loop `name`: `body(carry, consts) -> carry` is one body.
        `static` holds the Python values the body depends on besides the
        tensors' shapes; a graph is kept per name, shapes and `static`."""
        return LoopRun(self, name, body, carry, consts, static)

    def once(self, name: str, fn: Callable[[Tensors], Tensors], inputs: Tensors,
             static: tuple = ()) -> Tensors:
        """`fn(inputs) -> outputs`, the straight-line stretch `name` between
        two loops, as one graph replay when graphs are on; inline inside
        another stretch."""
        if not self.graphed or self._stretch is not None:
            return fn(inputs)
        key, inputs_s, _ = self._bind(name, inputs, {}, static)
        gkey = key + ("once",)
        if gkey not in self._graphs:
            outputs: Tensors = {}
            self._graphs[gkey] = self._capture(name, lambda: fn(inputs_s), outputs.update)
            self._graphs[gkey].outputs = outputs
        graph = self._graphs[gkey]
        graph.replay()
        self.stats[name]["replays"] += 1
        return {k: v.clone() for k, v in graph.outputs.items()}

    def graphs_of(self, name: str) -> List[_Graph]:
        """The graphs captured for loop or stretch `name`."""
        return [g for key, g in self._graphs.items() if key[0] == name]

    @property
    def inside(self) -> bool:
        """Whether a stretch is being warmed up or captured: its
        conditional bodies then decide on the device (`when`)."""
        return self._stretch is not None

    @contextlib.contextmanager
    def stretch(self, mode: str = "warm-up") -> Iterator[None]:
        """Run the code inside as the body of a stretch: nested stretches
        inline; `when` in "warm-up" runs every conditional body and selects
        on the device, in "capture" (inside a graph capture) makes
        conditional nodes."""
        saved, self._stretch = self._stretch, mode
        try:
            yield
        finally:
            self._stretch = saved

    def when(self, pred: torch.Tensor, body: Callable[[Tensors], Tensors],
             state: Tensors) -> Tensors:
        """`body(state)` where the 0-d bool `pred` is true, else `state`;
        the body returns tensors of `state`'s keys, shapes and dtypes and
        must not draw from the registered counters. Inside a stretch's
        capture it is a conditional IF node whose body copies its results
        into `state`'s tensors; else (a stretch's warm-up) the body runs and
        `pred` picks its results or `state` on the device. Outside a
        stretch, the caller decides on the host from its own read."""
        if self._stretch == "capture":
            return self._if_node(pred, body, state)
        self._branch_count += 1
        new = body(state)
        return {k: torch.where(pred, new[k], v) for k, v in state.items()}

    def repeat(self, name: str, pred: Callable[[Tensors], torch.Tensor], body: Body,
               carry: Tensors, consts: Tensors, static: tuple = ()) -> Tensors:
        """The loop `name`, as `lax.while_loop(pred, body, carry)`:
        `body(carry, consts) -> carry` while the 0-d bool `pred(carry)`
        holds. The body may draw from the registered counters (the draws
        advance their device words). With graphs on it is one stretch
        `name`, replayed: a WHILE node that reads nothing; inside a
        stretch's capture, the node; otherwise a Python loop that reads
        the predicate after every body (a stretch's warm-up runs it so on
        the body stream, once at least, so the body meets its libraries'
        workspaces there before the capture, its first run under PyTorch's
        sync check: a body that reads the host raises `CaptureError`)."""
        if self.graphed and self._stretch is None:
            def stretch(t: Tensors) -> Tensors:
                c = {k[2:]: v for k, v in t.items() if k.startswith("c.")}
                k = {k[2:]: v for k, v in t.items() if k.startswith("k.")}
                return self.repeat(name, pred, body, c, k)

            inputs = {**{"c." + k: v for k, v in carry.items()},
                      **{"k." + k: v for k, v in consts.items()}}
            return self.once(name, stretch, inputs, static)
        if self._stretch == "capture":
            return self._while_node(pred, body, carry, consts)
        c = dict(carry)
        if self._stretch == "warm-up":
            self._branch_count += 1
            current = torch.cuda.current_stream(self.device)
            self._body_stream.wait_stream(current)
            with torch.cuda.stream(self._body_stream):
                go = bool(pred(c))
                new = self._checked_body(name, body, c, consts)
                c = new if go else c
                while go and bool(pred(c)):
                    c = body(c, consts)
            current.wait_stream(self._body_stream)
            return c
        stats = self.stats[name]
        while self.read(name, pred(c))[0]:
            c = body(c, consts)
            stats["bodies"] += 1
        return c

    def _checked_body(self, name: str, body: Body, carry: Tensors, consts: Tensors) -> Tensors:
        """One run of a WHILE node's body with PyTorch's sync check raising:
        a body that reads the host in a way the check sees fails here, before
        its capture, with PyTorch's own message; one that syncs past the
        check fails its capture, which is abandoned (`_abort`)."""
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return body(carry, consts)
        except RuntimeError as exc:
            raise self._capture_error(name, exc) from exc
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    # -- graphs ------------------------------------------------------------
    def _if_node(self, pred: torch.Tensor, body: Callable[[Tensors], Tensors],
                 state: Tensors) -> Tensors:
        issued = [c.issued for c in self.counters]
        self._node(cuda_graphs.if_body, pred, lambda: body(state), state)
        if [c.issued for c in self.counters] != issued:
            raise RuntimeError("a conditional body drew from a call counter")
        return state

    def _while_node(self, pred: Callable[[Tensors], torch.Tensor], body: Body,
                    carry: Tensors, consts: Tensors) -> Tensors:
        flag = pred(carry)

        def run() -> Tensors:
            new = body(carry, consts)
            for k, v in carry.items():
                v.copy_(new[k])
            flag.copy_(pred(carry))  # the WHILE node's flag kernel reads it next
            return {}

        self._node(cuda_graphs.while_body, flag, run, {})
        return carry

    def _node(self, make, flag: torch.Tensor, work: Callable[[], Tensors],
              state: Tensors) -> None:
        """Capture `work()` as the body of a conditional node made by `make`
        on `flag`, its results copied into `state`'s tensors, and the
        body's launches and device word (one run, one add) recorded."""
        i = len(self._branches)
        if self._words is None or i >= self._words.numel():
            raise RuntimeError("a stretch met more conditional bodies in its capture than in "
                               "its warm-up")
        with make(flag, self._pool, self._body_stream) as nodes:
            before = _counts()  # after the node's flag kernel, which every replay runs
            new = work()
            for k, v in state.items():
                v.copy_(new[k])
            self._words[i:i + 1].add_(1)
        self._branches.append({k: v - before[k] for k, v in _counts().items()})
        self._body_nodes += nodes[0]

    def _bind(self, name: str, carry: Tensors, consts: Tensors, static: tuple):
        """The static buffers of loop `name` at these shapes, filled."""
        key = (name, _signature(carry), _signature(consts), static)
        if key not in self._statics:
            self._statics[key] = ({k: torch.empty_like(v) for k, v in carry.items()},
                                  {k: torch.empty_like(v) for k, v in consts.items()})
        carry_s, consts_s = self._statics[key]
        for src, dst in ((carry, carry_s), (consts, consts_s)):
            for k, v in src.items():
                dst[k].copy_(v)
        return key, carry_s, consts_s

    def _graph(self, key: tuple, body: Body, carry_s: Tensors, consts_s: Tensors,
               length: int) -> _Graph:
        gkey = key + (length,)
        if gkey not in self._graphs:
            def bodies():
                c = dict(carry_s)
                for _ in range(length):
                    c = body(c, consts_s)
                return c

            def commit(c):
                for k, v in carry_s.items():
                    v.copy_(c[k])

            self._graphs[gkey] = self._capture(key[0], bodies, commit)
        return self._graphs[gkey]

    def _capture(self, name: str, work: Callable[[], Tensors],
                 commit: Callable[[Tensors], None]) -> _Graph:
        """Capture `work()` (which reads static buffers only) and
        `commit(work())`, which writes its results where the graph keeps
        them, after one warm-up run of `work` alone, whose effects on the
        generators and the launch counts are undone: the warm-up leaves
        every static buffer as it was."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._body_stream is None:
            self._body_stream = torch.cuda.Stream(self.device)
        stream, current = self._stream, torch.cuda.current_stream(self.device)
        offsets = [g.get_offset() for g in self.generators]
        words = [c.state.clone() for c in self.counters]
        before = _counts()
        # Warm-up: libraries and workspaces meet the capture stream eagerly,
        # every conditional body included.
        self._branch_count = 0
        stream.wait_stream(current)
        with torch.cuda.stream(stream), self.stretch("warm-up"):
            work()
        current.wait_stream(stream)
        _add_launches({k: v - before[k] for k, v in _counts().items()}, -1)
        for g, offset in zip(self.generators, offsets):
            g.set_offset(offset)
        for c, saved in zip(self.counters, words):
            c.state.copy_(saved)

        # The conditional bodies' launch words and memory pool.
        words = torch.zeros(self._branch_count, dtype=torch.int64, device=self.device)
        self._words, self._branches, self._body_nodes = words, [], 0
        pool = None
        if self._branch_count:
            try:
                pool = cuda_graphs.body_pool(self._body_stream)
            except RuntimeError as exc:
                raise self._capture_error(name, exc) from exc
        self._pool = pool
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        stream.wait_stream(current)
        with torch.cuda.stream(stream), self.stretch("capture"):
            graph.capture_begin()
            t0 = time.perf_counter()
            try:
                commit(work())
                nodes = (cuda_graphs.capture_nodes(stream), self._body_nodes) if pool else None
            except Exception as exc:
                self._abort(graph, stream, pool)
                raise self._capture_error(name, exc) from exc
            try:
                graph.capture_end()
            except Exception as exc:
                self._abort(graph, stream, pool)
                raise self._capture_error(name, exc) from exc
        current.wait_stream(stream)
        branches, self._words, self._branches = self._branches, None, []
        captured = {k: v - before[k] for k, v in _counts().items()}
        _add_launches(captured, -1)
        for delta in branches:  # a replay counts these from the words
            captured = {k: v - delta[k] for k, v in captured.items()}
        self.stats[name]["captures"] += 1
        out = _Graph(graph, captured, (words, branches) if branches else None, self.stats[name])
        out.nodes, out.capture_s = nodes, time.perf_counter() - t0
        if pool is not None:  # the bodies' memory lives as long as the graph
            weakref.finalize(out, cuda_graphs.release_pool, self.device, pool).atexit = False
        return out

    def _abort(self, graph, stream, pool) -> None:
        """Abandon a failed capture on `stream`: its captures ended and their
        graphs destroyed, nothing instantiated, PyTorch's allocator routing
        and the graph's pool put back (`cuda_graphs.abort_capture`); then the
        generators out of capture mode and the body pool released."""
        try:
            cuda_graphs.abort_capture(graph, stream, self._body_stream)
        finally:
            self._repair_generators(stream, pool)

    def _repair_generators(self, stream, pool) -> None:
        """A capture that fails leaves its generators in capture mode; one
        small capture that succeeds takes them out of it. The failed
        capture's body pool goes back."""
        if pool is not None:
            cuda_graphs.release_pool(self.device, pool)
        try:
            fix = torch.cuda.CUDAGraph()
            for g in self.generators:
                fix.register_generator_state(g)
            with torch.cuda.stream(stream):
                fix.capture_begin()
                torch.zeros(1, device=self.device)
                fix.capture_end()
        except Exception:  # best effort: the capture's own error is what is raised
            pass

    @staticmethod
    def _capture_error(name: str, exc: Exception) -> CaptureError:
        return CaptureError(
            f"capturing the {name!r} loop as a CUDA graph failed: {type(exc).__name__}: {exc}\n"
            "Everything a loop body runs (in the MCMC steps, the likelihood and the prior "
            "transform) must stay on the device: no .item(), bool(tensor), .tolist(), "
            ".cpu() or host copies. The cluster fit's split rounds are CUDA-graph conditional "
            "nodes (ops.cuda_graphs), which need CUDA 12.4 or later. Run with "
            "run(on_device=False), which runs the same loops without CUDA graphs.")


class LoopRun:
    """One entry into a loop: its carry, advanced chunk by chunk."""

    def __init__(self, loops: Loops, name: str, body: Body, carry: Tensors, consts: Tensors,
                 static: tuple = ()):
        self.loops, self.name, self.body = loops, name, body
        self.graphed = loops.graphed
        if self.graphed:
            self._key, self.carry, self.consts = loops._bind(name, carry, consts, static)
        else:
            self.carry, self.consts = dict(carry), consts

    def advance(self, length: int, before_body: Optional[Callable[[], None]] = None) -> None:
        """Run `length` bodies; `before_body` is called before each one
        (eager runs only: a replay runs its bodies on the device)."""
        stats = self.loops.stats[self.name]
        stats["chunks"] += 1
        stats["bodies"] += length
        if self.graphed:
            self.loops._graph(self._key, self.body, self.carry, self.consts, length).replay()
            stats["replays"] += 1
            return
        for _ in range(length):
            if before_body is not None:
                before_body()
            self.carry = self.body(self.carry, self.consts)

    def read(self, *keys: str) -> List[float]:
        """The carry's `keys` on the host: the chunk's one read."""
        return self.loops.read(self.name, *(self.carry[k] for k in keys))

    def result(self) -> Tensors:
        """The carry; a copy of the static buffers after replays."""
        if self.graphed:
            return {k: v.clone() for k, v in self.carry.items()}
        return self.carry


def run_loop(loops: Optional[Loops], name: str, body: Body, carry: Tensors, consts: Tensors,
             static: tuple = ()) -> Tensors:
    """A whole loop: chunks of `loops.chunk(name)` bodies until the carry's
    scalar boolean "go" reads False. Every body must leave a carry whose
    "go" is False unchanged."""
    loops = loops or Loops(carry["go"].device)
    if carry["go"].dim() != 0:
        raise ValueError(f"the {name!r} loop's predicate must be a scalar")
    run = loops.start(name, body, carry, consts, static)
    while True:
        run.advance(loops.chunk(name))
        if not run.read("go")[0]:
            return run.result()
