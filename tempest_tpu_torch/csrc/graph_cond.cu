// Conditional IF and WHILE nodes of a CUDA graph made under stream capture.
//
// Replaces: nothing of the JAX package computes here. XLA runs the hierarchical
// fit's rounds as `lax.cond`s and a `lax.while_loop` on the device
// (tempest_tpu/cluster.py:928-950), and the adaptive MCMC chain as one
// `lax.while_loop` (tempest_tpu/mcmc.py:417); a CUDA graph expresses the same
// decisions as conditional nodes: an IF node's body graph runs only where a
// device flag is nonzero, a WHILE node's body graph runs again and again for
// as long as it is. PyTorch builds such nodes for `torch.cond` and
// `torch.while_loop` in later releases (`CUDAGraph.begin_capture_to_if_node`);
// the release this port runs on has no such call, so
// `tempest_tpu_torch/ops/cuda_graphs.py` makes them from these C entries:
//
//  - tempest_cond_begin(parent, body, pred, kind, route, &handle, &body_graph):
//    `parent` is capturing a graph. Creates a conditional handle in that
//    graph, captures onto `parent` a one-thread kernel that sets the handle
//    from the bool at `pred` when the graph runs, adds an IF (kind 0) or WHILE
//    (kind 1) node after the parent's current dependencies, makes the node
//    the parent's only dependency, starts a capture on stream `body` (route
//    0: a graph of its own; route 1: straight into the node's body graph),
//    and gives back the handle and the node's body graph;
//  - tempest_cond_end(body, body_graph, handle, pred, kind, route, &nodes):
//    ends the body's capture; on route 0 puts what it captured into the
//    node's body graph as one child graph node; for a WHILE node the
//    one-thread kernel that sets the handle from the predicate the body has
//    just computed comes last in the body (route 1: captured; route 0: added
//    after the child node), so the node runs its body once more only where
//    that is true; counts the body's nodes;
//  - tempest_capture_abort(stream, destroy): ends whatever capture the
//    stream is in, valid or invalidated, and destroys the graph that comes
//    back where `destroy` is set (a graph of its own; a node's body graph
//    belongs to its node), instantiating nothing (a failed body);
//  - tempest_capture_nodes(stream, &nodes) counts the top-level nodes of the
//    graph a stream is capturing (the graph's size, reported);
//  - tempest_capture_begin(stream) and tempest_capture_discard(stream)
//    capture a body as a graph of its own, outside any other capture, and
//    destroy what comes back, instantiating nothing: a trial, whose failure
//    the second returns.
//
// Why a body is captured apart and then added as a child graph: CUDA 12.8
// lets a stream capture straight into a conditional node's body graph
// (cudaStreamBeginCaptureToGraph), but when such a capture is invalidated
// half-way (a synchronizing call inside the body), ending the enclosing
// capture crashes the process (SIGSEGV in cudaStreamEndCapture, in every
// order of ending the two captures tried, on an H100 with CUDA 12.8:
// scripts/capture_probe.py). A body captured as a graph of its own fails
// alone: its capture ends with an error and no graph, and the enclosing
// capture then ends, valid or invalidated, without a crash. But a child
// graph may not hold a conditional node (cudaGraphAddChildGraphNode returns
// cudaErrorNotSupported: the probe's nested cases), so a body that holds
// conditional nodes of its own is captured straight into its node's body
// graph (route 1), and the innermost bodies, which hold none, as graphs of
// their own (route 0). A stream synchronization, a pinned copy or an event
// wait in an innermost body then still fails alone; a raw cudaMalloc or
// cudaDeviceSynchronize there invalidates the enclosing route-1 captures
// too, and ending those crashes the process (the probe's nested faults).
// PyTorch's allocator relaxes the capture mode around its own cudaMalloc,
// and its sync check sees torch.cuda.synchronize(); for the other calls
// the caller first captures each such innermost body alone, with no other
// capture open (tempest_capture_begin, tempest_capture_discard), where the
// fault fails that capture alone, and stops there.
//
// Whatever is captured on `body` between begin and end runs, at every launch
// of the graph, only where *pred was true when the node was reached (IF), or
// for as long as the handle reads true at the body's end (WHILE); the
// parent's later work waits for the node. Nothing here reads the host. The
// caller routes the body stream's allocations to a memory pool the replays
// keep. A body may hold kernel, memset, memcpy (device memory) and nested
// conditional nodes; CUDA refuses others, and the capture then fails.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int tempest_cond_begin(void* parent_stream, void* body_stream, const void* pred,
                                  int kind, int route, void* handle_out, void* body_graph_out) {
  if ((kind != 0 && kind != 1) || (route != 0 && route != 1)) return cudaErrorInvalidValue;
  cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional<<<1, 1, 0, parent>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind == 0 ? cudaGraphCondTypeIf : cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  *static_cast<uint64_t*>(handle_out) = static_cast<uint64_t>(handle);
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  *static_cast<cudaGraph_t*>(body_graph_out) = body_graph;
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  if (route == 1) {
    return cudaStreamBeginCaptureToGraph(body, body_graph, nullptr, nullptr, 0,
                                         cudaStreamCaptureModeThreadLocal);
  }
  return cudaStreamBeginCapture(body, cudaStreamCaptureModeThreadLocal);
}

// Ends the body's capture (from tempest_cond_begin) and, on route 0, adds
// what it captured to `body_graph` as a child graph node; for a WHILE node
// (kind 1) the kernel that sets conditional `handle` from the bool at `pred`
// comes last in the body. The int64 at `nodes` gets the body's node count,
// that kernel included. A capture that failed returns its error and adds
// nothing.
extern "C" int tempest_cond_end(void* body_stream, void* body_graph, uint64_t handle,
                                const void* pred, int kind, int route, void* nodes) {
  cudaStream_t stream = static_cast<cudaStream_t>(body_stream);
  cudaGraphConditionalHandle h = static_cast<cudaGraphConditionalHandle>(handle);
  const bool* p = static_cast<const bool*>(pred);
  size_t n = 0;
  if (route == 1) {
    if (kind == 1) set_conditional<<<1, 1, 0, stream>>>(h, p);
    cudaError_t launch = cudaGetLastError();
    cudaGraph_t same = nullptr;  // the node's body graph, which the node owns
    cudaError_t err = cudaStreamEndCapture(stream, &same);
    if (err == cudaSuccess) err = launch;
    if (err == cudaSuccess) {
      err = cudaGraphGetNodes(static_cast<cudaGraph_t>(body_graph), nullptr, &n);
    }
    *static_cast<int64_t*>(nodes) = static_cast<int64_t>(n);
    return err;
  }
  cudaGraph_t body = nullptr;
  cudaError_t err = cudaStreamEndCapture(stream, &body);
  if (err != cudaSuccess) {
    if (body != nullptr) cudaGraphDestroy(body);
    return err;
  }
  err = cudaGraphGetNodes(body, nullptr, &n);
  cudaGraphNode_t child;
  if (err == cudaSuccess) {
    err = cudaGraphAddChildGraphNode(&child, static_cast<cudaGraph_t>(body_graph), nullptr, 0,
                                     body);  // a clone
  }
  cudaGraphDestroy(body);
  if (err != cudaSuccess) return err;
  if (kind == 1) {
    void* args[] = {&h, &p};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(set_conditional);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    cudaGraphNode_t flag;
    err = cudaGraphAddKernelNode(&flag, static_cast<cudaGraph_t>(body_graph), &child, 1, &kp);
    if (err != cudaSuccess) return err;
    n += 1;
  }
  *static_cast<int64_t*>(nodes) = static_cast<int64_t>(n);
  return cudaSuccess;
}

// Ends the capture `stream` is in, if any, whether active or invalidated,
// and destroys the graph that comes back where `destroy` is nonzero, without
// instantiating it; clears the runtime's last error. Returns the error of
// ending it unless that is an invalidated capture's.
extern "C" int tempest_capture_abort(void* stream_ptr, int destroy) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaStreamCaptureStatus status;
  cudaError_t err = cudaStreamIsCapturing(stream, &status);
  if (err == cudaSuccess && status != cudaStreamCaptureStatusNone) {
    cudaGraph_t graph = nullptr;
    err = cudaStreamEndCapture(stream, &graph);
    if (graph != nullptr && destroy) cudaGraphDestroy(graph);
    if (err == cudaErrorStreamCaptureInvalidated) err = cudaSuccess;
  }
  cudaGetLastError();
  return err;
}

// Starts a capture of a graph of its own on `stream`, in the mode of a
// body's (tempest_cond_begin, route 0).
extern "C" int tempest_capture_begin(void* stream) {
  return cudaStreamBeginCapture(static_cast<cudaStream_t>(stream),
                                cudaStreamCaptureModeThreadLocal);
}

// Ends the capture tempest_capture_begin started on `stream`, destroys the
// graph that comes back without instantiating it and clears the runtime's
// last error; returns the error of ending it (an invalidated capture's:
// something inside it synchronized or allocated).
extern "C" int tempest_capture_discard(void* stream) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
  if (graph != nullptr) cudaGraphDestroy(graph);
  cudaGetLastError();
  return err;
}

// The int64 at `nodes` gets the node count of the graph `stream` is
// capturing, its top level.
extern "C" int tempest_capture_nodes(void* stream, void* nodes) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                                             nullptr, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *static_cast<int64_t*>(nodes) = static_cast<int64_t>(n);
  return err;
}

// CUDA's name of error `err`, into `out` (`size` bytes, NUL-terminated).
extern "C" int tempest_error_string(int err, void* out, int64_t size) {
  const char* name = cudaGetErrorString(static_cast<cudaError_t>(err));
  char* dst = static_cast<char*>(out);
  int64_t i = 0;
  for (; i + 1 < size && name[i] != '\0'; ++i) dst[i] = name[i];
  if (size > 0) dst[i] = '\0';
  return 0;
}
