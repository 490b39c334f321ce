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
//  - tempest_cond_begin(parent, body, pred, kind, &handle): `parent` is
//    capturing a graph. Creates a conditional handle in that graph, captures
//    onto `parent` a one-thread kernel that sets the handle from the bool at
//    `pred` when the graph runs, adds an IF (kind 0) or WHILE (kind 1) node
//    after the parent's current dependencies, makes the node the parent's
//    only dependency, starts capturing stream `body` into the node's body
//    graph, and gives the handle back;
//  - tempest_set_conditional(stream, handle, pred): captures the same
//    one-thread kernel onto `stream`: the last node of a WHILE body, which
//    sets the handle from the predicate the body has just computed, so the
//    node runs its body once more only where that is true;
//  - tempest_cond_end(body, &nodes): ends the body's capture and counts its
//    nodes; tempest_capture_nodes(stream, &nodes) counts the top-level nodes
//    of the graph a stream is capturing (the graph's size, reported).
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
                                  int kind, void* handle_out) {
  if (kind != 0 && kind != 1) return cudaErrorInvalidValue;
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
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                       params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

// Captures onto `stream` the kernel that sets conditional `handle` (from
// tempest_cond_begin) from the bool at `pred` when the graph runs.
extern "C" int tempest_set_conditional(void* stream, uint64_t handle, const void* pred) {
  set_conditional<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), static_cast<const bool*>(pred));
  return cudaGetLastError();
}

// Ends the body's capture; the int64 at `nodes` gets the body graph's
// node count.
extern "C" int tempest_cond_end(void* body_stream, void* nodes) {
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
  if (err != cudaSuccess) return err;
  size_t n = 0;
  err = cudaGraphGetNodes(body, nullptr, &n);
  *static_cast<int64_t*>(nodes) = static_cast<int64_t>(n);
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
