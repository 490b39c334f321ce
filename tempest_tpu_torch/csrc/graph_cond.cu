// Conditional IF nodes of a CUDA graph made under stream capture.
//
// Replaces: nothing of the JAX package computes here. XLA runs the hierarchical
// fit's rounds as `lax.cond`s and a `lax.while_loop` on the device
// (tempest_tpu/cluster.py:928-950); a CUDA graph expresses the same decision
// as a conditional node whose body graph runs only where a device flag is
// nonzero. PyTorch builds such nodes for `torch.cond` in later releases
// (`CUDAGraph.begin_capture_to_if_node`); the release this port runs on has
// no such call, so `tempest_tpu_torch/ops/cuda_graphs.py` makes them from
// these two C entries:
//
//  - tempest_if_begin(parent, body, pred): `parent` is capturing a graph.
//    Creates a conditional handle in that graph, captures onto `parent` a
//    one-thread kernel that sets the handle from the bool at `pred` when the
//    graph runs, adds an IF node after the parent's current dependencies,
//    makes the node the parent's only dependency, and starts capturing
//    stream `body` into the node's body graph;
//  - tempest_if_end(body, &nodes): ends that capture and counts the body's
//    nodes; tempest_capture_nodes(stream, &nodes) counts the top-level
//    nodes of the graph a stream is capturing (the graph's size, reported).
//
// Whatever is captured on `body` between the two calls runs, at every
// launch of the graph, only where *pred was true when the node was reached;
// the parent's later work waits for the node. Nothing here reads the host.
// The caller routes the body stream's allocations to the graph's memory
// pool. A body may hold kernel, memset, memcpy (device memory) and nested
// conditional nodes; CUDA refuses others, and the capture then fails.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int tempest_if_begin(void* parent_stream, void* body_stream, const void* pred) {
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
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                       params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

// Ends the body's capture; the int64 at `nodes` gets the body graph's
// node count.
extern "C" int tempest_if_end(void* body_stream, void* nodes) {
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
