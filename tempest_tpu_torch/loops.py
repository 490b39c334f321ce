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
  registered call counters and the kernels' launch counts are put back),
  and replayed from then on;
- a body draws from no generator (a generator's Philox offset is fixed at
  capture): every draw of a graphed sampler is keyed (`draws.Draws.keyed`);
- `counters` holds the call counters of the Philox kernels
  (`cuda_prng.PhiloxCounter`), whose device words the captured bodies
  read and advance; a capture leaves each word where it was, and every
  replay advances it as the eager bodies would (the host mirror is read
  from the word only when asked for); the words of every `DeviceCounts`
  (the reweight's probe counts) are treated alike on every `Loops`;
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
  when the counts are asked for; a body's launches are its own, those of
  the nodes nested in it counted by their own words. A `once` inside a
  stretch runs inline, with no capture of its own; the stretch's warm-up
  runs every conditional body once, on the body stream of its depth, and
  keeps its results where the predicate holds (`torch.where`), so each
  body meets its libraries and kernel builds before the capture. A draw
  from a registered call counter inside such a body advances the counter
  times the predicate (`cuda_prng.PhiloxCounter.guards`), as an untaken
  node draws nothing. Outside a stretch `when` decides on the host, from a
  read of the predicate or from a Python bool;
- conditional nodes nest (a WHILE node's body may hold IF and WHILE
  nodes, up to any depth): each depth captures on a stream and allocates
  from a pool of its own, a body that holds nodes is captured straight
  into its node's body graph and an innermost body as a child graph
  (`cuda_graphs.INTO_NODE`, `CHILD`; the warm-up records which is which);
  an innermost body nested in another body is also captured once in the
  warm-up as a graph of its own, outside any other capture, and discarded
  (`cuda_graphs.alone`), so that a raw cudaMalloc or cudaDeviceSynchronize
  in it (a likelihood on another CUDA library) fails there alone, not
  inside captures made straight into their nodes, whose end CUDA would
  crash on; the run loop calls the likelihood and the prior transform in
  such bodies only;
- `repeat` runs a body while a 0-d device bool of its carry holds, as
  `lax.while_loop` does: captured (a stretch of its own, or inside one), it
  is a CUDA-graph conditional WHILE node whose body runs on the device for
  as long as the predicate it recomputes holds, so a replay runs the whole
  loop and reads nothing; each run of the body adds one to its device word,
  which counts its launches and its runs (`stats[name]["node_bodies"]`, the
  runs of the loop's bodies, wherever its node sits). The body may update
  the carry's tensors in place (a history slot written through a device
  index): the node then copies nothing. Eagerly (graphs off, the CPU) it
  is a Python loop that reads the predicate after every body, so it runs
  the same bodies and launches the same kernels as the node; a stretch's
  warm-up on a CUDA device runs the body once, on a copy of the carry, so
  the static buffers stay as they were; on the CPU, where no capture
  follows, it runs that Python loop on the copy, so a stretch decided on
  the device gives the whole loop's result there;
- a host call (`utils.wrappers.HostLikelihood`, a host likelihood's
  crossing) inside a stretch is captured as the host-call kernel
  (`ops.cuda_host`); the graph notes its mailbox (`_Graph.hosts`) and every
  replay of it serves the calls on the thread that replays it until the
  graph has finished, then re-raises what the likelihood raised; the
  word the kernel sets where it raised is `halt`, which the predicates
  around it AND in (`unhalted`); a capture's warm-up and trial call
  nothing on the host;
- a capture that fails (a body that reads the host, such as a likelihood
  calling `.item()`, or synchronizes or allocates in a way PyTorch's sync
  check misses) raises `CaptureError` naming the cause and
  `on_device=False`, after the
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

import numpy as np
import torch

from .ops import cuda_em, cuda_graphs, cuda_host, cuda_linalg, cuda_median, cuda_prng, cuda_reweight
from .ops.tools import _psum

Tensors = Dict[str, torch.Tensor]
Body = Callable[[Tensors, Tensors], Tensors]


class CaptureError(RuntimeError):
    """A loop chunk could not be captured as a CUDA graph."""


def _counts() -> Dict[str, int]:
    return {"ess_bisect": cuda_reweight.LAUNCHES, "ess_bisect_f64": cuda_reweight.LAUNCHES_F64,
            "ess_bracket": cuda_reweight.BRACKET_LAUNCHES, "sym_eigvals": cuda_linalg.LAUNCHES,
            "weighted_median": cuda_median.LAUNCHES, "set_conditional": cuda_graphs.LAUNCHES,
            "host_call": cuda_host.LAUNCHES, **cuda_em.LAUNCHES, **cuda_prng.LAUNCHES}


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
        words, launches, stats = graph.branches
        for taken, delta, counter in zip(words.tolist(), launches, stats):
            _add_launches({k: taken * v for k, v in delta.items()})
            counter["node_bodies"] += taken
        words.zero_()
    _UNSETTLED.clear()


def _add_launches(delta: Dict[str, int], sign: int = 1) -> None:
    cuda_reweight.LAUNCHES += sign * delta["ess_bisect"]
    cuda_reweight.LAUNCHES_F64 += sign * delta["ess_bisect_f64"]
    cuda_reweight.BRACKET_LAUNCHES += sign * delta["ess_bracket"]
    cuda_linalg.LAUNCHES += sign * delta["sym_eigvals"]
    cuda_median.LAUNCHES += sign * delta["weighted_median"]
    cuda_graphs.LAUNCHES += sign * delta["set_conditional"]
    cuda_host.LAUNCHES += sign * delta["host_call"]
    for counts in (cuda_em.LAUNCHES, cuda_prng.LAUNCHES):
        for name in counts:
            counts[name] += sign * delta[name]


def _signature(tensors: Tensors) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(tensors.items()))


class _Graph:
    """One captured chunk and the kernel launches its capture made outside
    conditional nodes; `outputs` holds the tensors a straight-line stretch
    returns; `branches`, where it has conditional nodes, their device words
    (one int64 each, the bodies run since the last `settle_launches`), each
    body's own launches (those of the nodes nested in it left out) and the
    counters of the loop each body belongs to (`Loops.stats`); `hosts`, the
    mailboxes of the host calls it holds (`ops.cuda_host`), which its
    replays serve."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: Dict[str, int],
                 branches: Optional[tuple] = None, hosts: tuple = ()):
        self.graph, self.launches, self.branches = graph, launches, branches
        self.hosts = hosts
        self.outputs: Tensors = {}
        # (top-level nodes, nodes in conditional bodies) where it has any,
        # the deepest nesting of its nodes, and the seconds its capture and
        # instantiation took
        self.nodes: Optional[tuple] = None
        self.depth = 0
        self.capture_s = 0.0

    def replay(self) -> None:
        """Launch the graph; where it holds host calls, serve them on this
        thread until it has finished (`cuda_host.served`), and raise what
        a host function raised."""
        try:
            if self.hosts:
                cuda_host.served(self.graph.replay, self.hosts)
            else:
                self.graph.replay()
        finally:
            _add_launches(self.launches)
            if self.branches is not None:
                _UNSETTLED.add(self)


def _device_key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceCounts:
    """Named counts, one int64 device word each on every device that adds
    to them, read on the host only when asked (`self[name]`, the sum over
    the devices; `dict(self)` reads them all). `add` adds on the stream, so
    an add inside a captured body runs at every replay of it, and a count
    taken inside the device run loop is read once, after the dispatch.
    Every `Loops` treats these words as it treats its `counters`: an add
    inside a conditional body of a stretch's warm-up counts times the
    body's predicate (`guards`), and a capture's warm-up leaves the words
    as they were."""

    _ALL: "weakref.WeakSet[DeviceCounts]" = weakref.WeakSet()

    class Words:
        """The words of one device (`state`, one a name) and the 0-d
        predicates of the conditional bodies being warmed up around an add."""

        def __init__(self, n: int, device: torch.device):
            self.state = torch.zeros(n, dtype=torch.int64, device=device)
            self.guards: List[torch.Tensor] = []

    def __init__(self, *names: str):
        self.names = names
        self._words: Dict[torch.device, DeviceCounts.Words] = {}
        DeviceCounts._ALL.add(self)

    def words(self, device) -> "DeviceCounts.Words":
        """The words on `device`, made (zero) on first use; made outside any
        capture, as a `Loops` asks for them before it captures."""
        key = _device_key(device)
        if key not in self._words:
            self._words[key] = DeviceCounts.Words(len(self.names), key)
        return self._words[key]

    def add(self, name: str, n, device) -> None:
        """Add `n` (a Python int or a 0-d or one-element device integer) to
        count `name` on `device`, times each of the guards."""
        words = self.words(device)
        value = n.reshape(()).to(torch.int64) if isinstance(n, torch.Tensor) else int(n)
        for guard in words.guards:
            value = guard.to(torch.int64) * value
        i = self.names.index(name)
        words.state[i:i + 1].add_(value)

    def keys(self):
        return self.names

    def __getitem__(self, name: str) -> int:
        i = self.names.index(name)
        return sum(int(w.state[i]) for w in self._words.values())


class Loops:
    """The loops of one sampler: chunk lengths, reads, and the graph cache."""

    def __init__(self, device, chunks: Optional[Dict[str, int]] = None, graphs: bool = False,
                 counters: Optional[list] = None):
        self.device = torch.device(device)
        self.chunks = dict(chunks or {})
        self.graphs = graphs
        self.counters = list(counters or [])
        self.stats: Dict[str, Counter] = defaultdict(Counter)
        # The device word a host call sets where its host function raised
        # (`utils.wrappers.HostLikelihood`), which `unhalted` ANDs into the
        # predicates of the loops around it.
        self.halt: Optional[torch.Tensor] = None
        self._statics: Dict[tuple, tuple] = {}
        self._graphs: Dict[tuple, _Graph] = {}
        self._pinned: Optional[torch.Tensor] = None
        self._event = None
        self._stream = None
        # Inside a stretch: None, "warm-up" or "capture". The warm-up records
        # each conditional body met, in the order the capture meets them:
        # its loop's name and whether it holds nodes of its own; `_open`
        # holds the bodies being run, `_depth` their nesting.
        self._stretch: Optional[str] = None
        self._names: List[str] = []
        self._holds: List[bool] = []
        self._open: List[int] = []
        self._depth = 0
        self._max_depth = 0
        # During a capture: the bodies' device words, each body's own
        # launches, the launches of the nodes inside each open body, the next
        # body's index, the bodies' node count and a memory pool a depth.
        self._words: Optional[torch.Tensor] = None
        self._branches: List[Optional[Dict[str, int]]] = []
        self._nested: List[Dict[str, int]] = []
        self._next_body = 0
        self._body_nodes = 0
        self._pools: list = []
        self._body_streams: List[torch.cuda.Stream] = []
        # During a warm-up: the stretch's name and the pool of its bodies'
        # trial captures (`_trial`).
        self._capturing = ""
        self._trial_pool = None
        # During a capture: the mailboxes of the host calls captured.
        self._hosts: list = []

    def chunk(self, name: str) -> int:
        """The bodies a chunk of loop `name` runs between its reads."""
        return self.chunks.get(name, 1)

    def _counters(self) -> list:
        """The registered counters and the `DeviceCounts` words on this device."""
        return self.counters + [c.words(self.device) for c in list(DeviceCounts._ALL)]

    @property
    def graphed(self) -> bool:
        return self.graphs and self.device.type == "cuda"

    def read(self, name: str, *tensors: torch.Tensor) -> List[float]:
        """The values of `tensors` (flattened, in order) on the host: one
        blocking read, counted for loop `name`."""
        return self.fetch(name, *tensors).tolist()

    def fetch(self, name: str, *tensors: torch.Tensor) -> np.ndarray:
        """`read`'s values as a float64 numpy array: one blocking read,
        counted for loop `name`."""
        self.stats[name]["reads"] += 1
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
        if flat.device.type != "cuda":
            return flat.numpy()
        n = flat.numel()
        if self._pinned is None or self._pinned.numel() < n:
            self._pinned = torch.empty(max(n, 64), dtype=torch.float64, pin_memory=True)
            self._event = torch.cuda.Event()
        self._pinned[:n].copy_(flat, non_blocking=True)
        self._event.record()
        self._event.synchronize()
        return self._pinned[:n].numpy().copy()

    def unhalted(self, pred: torch.Tensor, group=None) -> torch.Tensor:
        """`pred` and the host call's function did not raise (`halt`, summed
        over the ranks of `group`): a loop around a host call that failed
        ends after the body that made it."""
        if self.halt is None:
            return pred
        return pred & (_psum(self.halt, group) == 0).reshape(pred.shape)

    @property
    def guards(self) -> List[torch.Tensor]:
        """The predicates of the conditional bodies a stretch's warm-up is
        in around the caller: the guard stack `_warm` keeps in every
        counter, read from the first."""
        counters = self._counters()
        return list(counters[0].guards) if counters else []

    @property
    def capturing(self) -> bool:
        """Whether a stretch is being captured (not warmed up)."""
        return self._stretch == "capture"

    def note_host(self, box) -> None:
        """Record host-call mailbox `box` in the graph being captured, whose
        replays then serve it."""
        if box not in self._hosts:
            self._hosts.append(box)

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
        conditional nodes. A warm-up entered from outside any stretch starts
        the record of the bodies it meets."""
        saved, self._stretch = self._stretch, mode
        if saved is None and mode == "warm-up":
            self._names, self._holds, self._open, self._max_depth = [], [], [], 0
        try:
            yield
        finally:
            self._stretch = saved

    def when(self, pred, body: Callable[[Tensors], Tensors], state: Tensors,
             name: str = "when") -> Tensors:
        """`body(state)` where `pred` is true, else `state`; the body returns
        tensors of `state`'s keys, shapes and dtypes. `pred` is a Python bool
        (decided already) or a 0-d device bool. Inside a stretch's capture it
        is a conditional IF node whose body writes its results into copies
        of `state`'s tensors; in a stretch's warm-up the body runs and `pred`
        picks its results or `state` on the device, a draw from a registered
        counter inside it advancing the counter times `pred`. Outside a
        stretch the host decides: it reads `pred` (counted for `name`) and
        runs the body or not. The body's node runs count for `name`."""
        if isinstance(pred, bool):
            return body(state) if pred else state
        if self._stretch == "capture":
            return self._if_node(pred, body, state, name)
        if self._stretch is None:
            return body(state) if self.read(name, pred)[0] else state
        new = self._warm(name, pred, lambda: body(state))
        return {k: torch.where(pred, new[k], v) for k, v in state.items()}

    def repeat(self, name: str, pred: Callable[[Tensors], torch.Tensor], body: Body,
               carry: Tensors, consts: Tensors, static: tuple = ()) -> Tensors:
        """The loop `name`, as `lax.while_loop(pred, body, carry)`:
        `body(carry, consts) -> carry` while the 0-d bool `pred(carry)`
        holds. The body may draw from the registered counters (the draws
        advance their device words) and may update the carry's tensors in
        place. With graphs on it is one stretch `name`, replayed: a WHILE
        node that reads nothing; inside a stretch's capture, the node;
        otherwise a Python loop that reads the predicate after every body. A
        stretch's warm-up runs the body once, on a copy of the carry and on
        the body stream of its depth, so the body meets its libraries'
        workspaces there before the capture, under PyTorch's sync check: a
        body that reads the host raises `CaptureError`."""
        if self.graphed and self._stretch is None:
            def stretch(t: Tensors) -> Tensors:
                c = {k[2:]: v for k, v in t.items() if k.startswith("c.")}
                k = {k[2:]: v for k, v in t.items() if k.startswith("k.")}
                return self.repeat(name, pred, body, c, k)

            inputs = {**{"c." + k: v for k, v in carry.items()},
                      **{"k." + k: v for k, v in consts.items()}}
            return self.once(name, stretch, inputs, static)
        if self._stretch == "capture":
            return self._while_node(name, pred, body, carry, consts)
        if self._stretch == "warm-up":
            go = pred(carry)

            def run() -> Tensors:
                copy = {k: v.clone() for k, v in carry.items()}
                if self.device.type != "cuda":  # no capture follows: the whole loop
                    return self._loop(name, pred, body, copy, consts)
                new = self._checked_body(name, body, copy, consts)
                pred(new)  # the WHILE node's flag, computed at the body's end
                return new

            new = self._warm(name, go, run)
            return {k: torch.where(go, new[k], v) for k, v in carry.items()}
        return self._loop(name, pred, body, dict(carry), consts)

    def _loop(self, name: str, pred: Callable[[Tensors], torch.Tensor], body: Body,
              c: Tensors, consts: Tensors) -> Tensors:
        """`repeat` as a Python loop: a read of the predicate after every body."""
        stats = self.stats[name]
        while self.read(name, pred(c))[0]:
            c = body(c, consts)
            stats["bodies"] += 1
        return c

    def _warm(self, name: str, pred: torch.Tensor, run: Callable[[], Tensors]) -> Tensors:
        """`run()` as a conditional body of loop `name` in a stretch's
        warm-up: on the body stream of its depth, recorded in the order a
        capture meets it, the registered counters advancing times `pred`.
        A body nested in another body that holds no node of its own is then
        captured once more, alone, and discarded (`_trial`): its capture
        proper will sit inside captures made straight into their nodes,
        which a raw cudaMalloc or cudaDeviceSynchronize in it would
        invalidate too, and CUDA kills the process when those end."""
        i = len(self._holds)
        if self._open:
            self._holds[self._open[-1]] = True
        self._names.append(name)
        self._holds.append(False)
        self._open.append(i)
        self._depth += 1
        self._max_depth = max(self._max_depth, self._depth)
        counters = self._counters()
        for c in counters:
            c.guards.append(pred)
        try:
            if self.device.type != "cuda":
                return run()
            stream = self._body_stream(self._depth)
            current = torch.cuda.current_stream(self.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                out = run()
                if self._depth > 1 and not self._holds[i]:
                    self._trial(name, run, stream)
            current.wait_stream(stream)
            return out
        finally:
            for c in counters:
                c.guards.pop()
            self._depth -= 1
            self._open.pop()

    def _trial(self, name: str, run: Callable[[], Tensors], stream) -> None:
        """Capture `run()`, body `name` of the stretch being warmed up, on
        `stream` as a graph of its own outside any other capture, and
        discard it (`cuda_graphs.alone`): a body that synchronizes or
        allocates past PyTorch's check fails alone here, and raises
        `CaptureError` naming the stretch."""
        if self._trial_pool is None:
            self._trial_pool = cuda_graphs.body_pool(stream)
        try:
            with cuda_graphs.alone(self._trial_pool, stream):
                run()
        except Exception as exc:
            cause = RuntimeError(f"its {name!r} body, captured alone: {type(exc).__name__}: {exc}")
            raise self._capture_error(self._capturing, cause) from exc

    def _body_stream(self, depth: int) -> Optional[torch.cuda.Stream]:
        """The stream the conditional bodies of nesting `depth` (1 for a
        stretch's own nodes) run and are captured on."""
        if self.device.type != "cuda":
            return None
        while len(self._body_streams) < depth:
            self._body_streams.append(torch.cuda.Stream(self.device))
        return self._body_streams[depth - 1]

    def _checked_body(self, name: str, body: Body, carry: Tensors, consts: Tensors) -> Tensors:
        """One run of a WHILE node's body with PyTorch's sync check raising:
        a body that reads the host in a way the check sees fails here, before
        its capture, with PyTorch's own message; one that syncs past the
        check fails its capture, which is abandoned (`_abort`)."""
        if self.device.type != "cuda":
            return body(carry, consts)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return body(carry, consts)
        except CaptureError:  # a nested body's, named already
            raise
        except RuntimeError as exc:
            raise self._capture_error(name, exc) from exc
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    # -- graphs ------------------------------------------------------------
    def _if_node(self, pred: torch.Tensor, body: Callable[[Tensors], Tensors],
                 state: Tensors, name: str) -> Tensors:
        out = {k: v.clone() for k, v in state.items()}  # the result where pred is false
        self._node(cuda_graphs.if_body, pred, lambda: body(state), out, name)
        return out

    def _while_node(self, name: str, pred: Callable[[Tensors], torch.Tensor], body: Body,
                    carry: Tensors, consts: Tensors) -> Tensors:
        flag = pred(carry)

        def run() -> Tensors:
            new = body(carry, consts)
            for k, v in carry.items():
                if new[k] is not v:
                    v.copy_(new[k])
            flag.copy_(pred(carry))  # the WHILE node's flag kernel reads it next
            return {}

        self._node(cuda_graphs.while_body, flag, run, {}, name)
        return carry

    def _node(self, make, flag: torch.Tensor, work: Callable[[], Tensors], state: Tensors,
              name: str) -> None:
        """Capture `work()` as the body of a conditional node made by `make`
        on `flag`, its results copied into `state`'s tensors, on the body
        stream and pool of its depth, straight into the node where the
        warm-up saw it hold nodes of its own; record the body's own launches
        and device word (one run, one add)."""
        i = self._next_body
        if self._words is None or i >= self._words.numel() or self._names[i] != name:
            raise RuntimeError("a stretch met other conditional bodies in its capture than in "
                               "its warm-up")
        self._next_body += 1
        self._depth += 1
        route = cuda_graphs.INTO_NODE if self._holds[i] else cuda_graphs.CHILD
        self._nested.append(dict.fromkeys(_counts(), 0))
        try:
            with make(flag, self._pools[self._depth - 1], self._body_stream(self._depth),
                      route) as nodes:
                before = _counts()  # after the node's flag kernel, which its parent runs
                new = work()
                for k, v in state.items():
                    v.copy_(new[k])
                self._words[i:i + 1].add_(1)
        finally:
            self._depth -= 1
            nested = self._nested.pop()
        total = {k: v - before[k] for k, v in _counts().items()}
        self._branches[i] = {k: v - nested[k] for k, v in total.items()}
        if self._nested:
            for k, v in total.items():
                self._nested[-1][k] += v
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
        call counters and the launch counts are undone: the warm-up leaves
        every static buffer as it was."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream, current = self._stream, torch.cuda.current_stream(self.device)
        counters = self._counters()
        words = [c.state.clone() for c in counters]
        before = _counts()
        # Warm-up: libraries and workspaces meet the capture stream eagerly,
        # every conditional body included, each on its depth's stream.
        self._capturing = name
        stream.wait_stream(current)
        try:
            with torch.cuda.stream(stream), self.stretch("warm-up"):
                work()
        finally:
            if self._trial_pool is not None:
                cuda_graphs.release_pool(self.device, self._trial_pool)
                self._trial_pool = None
        current.wait_stream(stream)
        _add_launches({k: v - before[k] for k, v in _counts().items()}, -1)
        for c, saved in zip(counters, words):
            c.state.copy_(saved)

        # The conditional bodies' launch words and memory pools, one a depth.
        n_bodies = len(self._names)
        words = torch.zeros(n_bodies, dtype=torch.int64, device=self.device)
        self._words, self._branches, self._body_nodes = words, [None] * n_bodies, 0
        self._next_body = 0
        self._hosts = []
        pools = []
        try:
            for depth in range(1, self._max_depth + 1):
                pools.append(cuda_graphs.body_pool(self._body_stream(depth)))
        except RuntimeError as exc:
            self._release(pools)
            raise self._capture_error(name, exc) from exc
        self._pools = pools
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(current)
        with torch.cuda.stream(stream), self.stretch("capture"):
            graph.capture_begin()
            t0 = time.perf_counter()
            try:
                commit(work())
                if self._next_body != n_bodies:
                    raise RuntimeError("a stretch met fewer conditional bodies in its capture "
                                       "than in its warm-up")
                nodes = (cuda_graphs.capture_nodes(stream), self._body_nodes) if pools else None
            except Exception as exc:
                self._abort(graph, stream, pools)
                raise self._capture_error(name, exc) from exc
            try:
                graph.capture_end()
            except Exception as exc:
                self._abort(graph, stream, pools)
                raise self._capture_error(name, exc) from exc
        current.wait_stream(stream)
        branches, self._words, self._pools = self._branches, None, []
        hosts, self._hosts = tuple(self._hosts), []
        captured = {k: v - before[k] for k, v in _counts().items()}
        _add_launches(captured, -1)
        for delta in branches:  # a replay counts these from the words
            captured = {k: v - delta[k] for k, v in captured.items()}
        self.stats[name]["captures"] += 1
        stats = [self.stats[n] for n in self._names]
        out = _Graph(graph, captured, (words, branches, stats) if branches else None, hosts)
        out.nodes, out.depth, out.capture_s = nodes, self._max_depth, time.perf_counter() - t0
        if pools:  # the bodies' memory lives as long as the graph
            weakref.finalize(out, self._release, pools).atexit = False
        return out

    def _release(self, pools: list) -> None:
        for pool in pools:
            cuda_graphs.release_pool(self.device, pool)

    def _abort(self, graph, stream, pools: list) -> None:
        """Abandon a failed capture on `stream`: its captures ended and their
        graphs destroyed, nothing instantiated, PyTorch's allocator routing
        and the graph's pool put back (`cuda_graphs.abort_capture`); then the
        default generator out of capture mode and the body pools released."""
        self._depth, self._nested = 0, []
        try:
            cuda_graphs.abort_capture(graph, stream, self._body_streams)
        finally:
            self._repair_generators(stream, pools)

    def _repair_generators(self, stream, pools: list) -> None:
        """A capture that fails leaves the generators it registered (PyTorch's
        default CUDA generator, which every capture registers) in capture
        mode; one small capture that succeeds takes them out of it. The
        failed capture's body pools go back."""
        self._release(pools)
        self._pools = []
        try:
            fix = torch.cuda.CUDAGraph()
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
