// What CUDA does when the capture of a conditional node's body fails half-way,
// and which way of ending the two captures survives; built and run by
// scripts/capture_probe.py, one process a case:
//   capture_probe <if|while> <fault> <strategy>
// fault: none, sync (cudaStreamSynchronize of the body's stream), pinned (a
//   copy to pinned host memory), event (cudaEventSynchronize of an event
//   recorded in the body), malloc (cudaMalloc), devsync
//   (cudaDeviceSynchronize), each made inside the body's capture;
// strategy, the body captured straight into the node's body graph
//   (cudaStreamBeginCaptureToGraph) unless noted:
//   torch        end the body (its error ignored), end the enclosing
//                capture, instantiate and launch what comes back;
//   destroy      the same, destroying without instantiating;
//   skipbody     end the enclosing capture only;
//   parentfirst  end the enclosing capture, then the body;
//   child        the body captured as a graph of its own and added to the
//                node's body graph as a child graph node once it ends well
//                (csrc/graph_cond.cu's design).
// Then, whatever happened, a clean capture of an IF node on new streams is
// made and replayed ("ALIVE ... x = 2").
#include <cuda_runtime.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define R(call)                                                                     \
  do {                                                                              \
    cudaError_t e_ = (call);                                                        \
    printf("  %s -> %d %s\n", #call, (int)e_, cudaGetErrorName(e_));                \
    fflush(stdout);                                                                 \
  } while (0)

__global__ void set_cond(cudaGraphConditionalHandle h, const bool* p) {
  cudaGraphSetConditional(h, *p ? 1u : 0u);
}
__global__ void add1(int* x) { x[0] += 1; }
__global__ void step(int* x, int* left, bool* p) {
  x[0] += 2;
  left[0] -= 1;
  *p = left[0] > 0;
}

static const char* status_name(cudaStream_t s) {
  cudaStreamCaptureStatus st;
  cudaError_t e = cudaStreamIsCapturing(s, &st);
  if (e != cudaSuccess) return cudaGetErrorName(e);
  return st == cudaStreamCaptureStatusNone ? "none"
         : st == cudaStreamCaptureStatusActive ? "active" : "invalidated";
}

int main(int argc, char** argv) {
  if (argc < 4) return 2;
  const bool is_while = strcmp(argv[1], "while") == 0;
  const char* fault = argv[2];
  const char* strat = argv[3];
  const bool child = strcmp(strat, "child") == 0;
  printf("case %s %s %s\n", argv[1], fault, strat);
  cudaStream_t parent, body;
  cudaStreamCreateWithFlags(&parent, cudaStreamNonBlocking);
  cudaStreamCreateWithFlags(&body, cudaStreamNonBlocking);
  int *x, *left, *host;
  bool* pred;
  cudaMalloc(&x, 4);
  cudaMalloc(&left, 4);
  cudaMalloc(&pred, 1);
  cudaMallocHost(&host, 4);
  cudaEvent_t ev;
  cudaEventCreate(&ev);
  cudaMemset(x, 0, 4);
  int three = 3;
  cudaMemcpy(left, &three, 4, cudaMemcpyHostToDevice);
  cudaMemset(pred, 1, 1);
  cudaDeviceSynchronize();

  R(cudaStreamBeginCapture(parent, cudaStreamCaptureModeGlobal));
  add1<<<1, 1, 0, parent>>>(x);
  cudaStreamCaptureStatus st;
  cudaGraph_t graph;
  cudaStreamGetCaptureInfo(parent, &st, nullptr, &graph, nullptr, nullptr);
  cudaGraphConditionalHandle handle;
  R(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
  set_cond<<<1, 1, 0, parent>>>(handle, pred);
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaStreamGetCaptureInfo(parent, &st, nullptr, &graph, &deps, &n_deps);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  R(cudaGraphAddNode(&node, graph, deps, n_deps, &params));
  R(cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies));
  cudaGraph_t node_body = params.conditional.phGraph_out[0];
  if (child) {
    R(cudaStreamBeginCapture(body, cudaStreamCaptureModeThreadLocal));
  } else {
    R(cudaStreamBeginCaptureToGraph(body, node_body, nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal));
  }
  if (is_while) {
    step<<<1, 1, 0, body>>>(x, left, pred);
  } else {
    add1<<<1, 1, 0, body>>>(x);
  }
  if (!strcmp(fault, "sync")) R(cudaStreamSynchronize(body));
  if (!strcmp(fault, "pinned")) R(cudaMemcpyAsync(host, x, 4, cudaMemcpyDeviceToHost, body));
  if (!strcmp(fault, "event")) {
    R(cudaEventRecord(ev, body));
    R(cudaEventSynchronize(ev));
  }
  if (!strcmp(fault, "malloc")) {
    void* p = nullptr;
    R(cudaMalloc(&p, 256));
  }
  if (!strcmp(fault, "devsync")) R(cudaDeviceSynchronize());
  if (is_while) {
    set_cond<<<1, 1, 0, body>>>(handle, pred);
  } else {
    add1<<<1, 1, 0, body>>>(x);
  }
  R(cudaGetLastError());
  printf("  status: body %s, parent %s\n", status_name(body), status_name(parent));
  fflush(stdout);

  cudaGraph_t bg = nullptr, pg = nullptr;
  if (!strcmp(strat, "parentfirst")) {
    R(cudaStreamEndCapture(parent, &pg));
    printf("  parent graph %p\n", (void*)pg);
    if (pg) R(cudaGraphDestroy(pg));
    R(cudaStreamEndCapture(body, &bg));
    printf("  body graph %p\n", (void*)bg);
  } else {
    if (strcmp(strat, "skipbody") != 0) {
      R(cudaStreamEndCapture(body, &bg));
      printf("  body graph %p (node body %p)\n", (void*)bg, (void*)node_body);
      if (child && bg) {
        cudaGraphNode_t cn;
        R(cudaGraphAddChildGraphNode(&cn, node_body, nullptr, 0, bg));
        R(cudaGraphDestroy(bg));
      }
    }
    R(cudaGetLastError());
    printf("  status before the parent's end: body %s, parent %s\n", status_name(body),
           status_name(parent));
    fflush(stdout);
    R(cudaStreamEndCapture(parent, &pg));
    printf("  parent graph %p\n", (void*)pg);
    fflush(stdout);
    if (pg && !strcmp(strat, "torch")) {
      cudaGraphExec_t exec;
      R(cudaGraphInstantiate(&exec, pg, 0));
      R(cudaGraphLaunch(exec, parent));
      R(cudaStreamSynchronize(parent));
      int got = -1;
      cudaMemcpy(&got, x, 4, cudaMemcpyDeviceToHost);
      printf("  replay x = %d\n", got);
      cudaGraphExecDestroy(exec);
    }
    if (pg) R(cudaGraphDestroy(pg));
  }
  R(cudaGetLastError());
  printf("  status after: body %s, parent %s\n", status_name(body), status_name(parent));

  // Afterwards: a clean capture of an IF node on new streams, replayed.
  cudaStream_t s2, b2;
  cudaStreamCreateWithFlags(&s2, cudaStreamNonBlocking);
  cudaStreamCreateWithFlags(&b2, cudaStreamNonBlocking);
  cudaMemset(x, 0, 4);
  cudaMemset(pred, 1, 1);
  cudaDeviceSynchronize();
  R(cudaStreamBeginCapture(s2, cudaStreamCaptureModeGlobal));
  cudaStreamGetCaptureInfo(s2, &st, nullptr, &graph, nullptr, nullptr);
  R(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
  set_cond<<<1, 1, 0, s2>>>(handle, pred);
  cudaStreamGetCaptureInfo(s2, &st, nullptr, &graph, &deps, &n_deps);
  cudaGraphNodeParams p2 = {};
  p2.type = cudaGraphNodeTypeConditional;
  p2.conditional.handle = handle;
  p2.conditional.type = cudaGraphCondTypeIf;
  p2.conditional.size = 1;
  R(cudaGraphAddNode(&node, graph, deps, n_deps, &p2));
  R(cudaStreamUpdateCaptureDependencies(s2, &node, 1, cudaStreamSetCaptureDependencies));
  if (child) {
    R(cudaStreamBeginCapture(b2, cudaStreamCaptureModeThreadLocal));
  } else {
    R(cudaStreamBeginCaptureToGraph(b2, p2.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal));
  }
  add1<<<1, 1, 0, b2>>>(x);
  add1<<<1, 1, 0, b2>>>(x);
  R(cudaStreamEndCapture(b2, &bg));
  if (child && bg) {
    cudaGraphNode_t cn;
    R(cudaGraphAddChildGraphNode(&cn, p2.conditional.phGraph_out[0], nullptr, 0, bg));
    cudaGraphDestroy(bg);
  }
  R(cudaStreamEndCapture(s2, &pg));
  cudaGraphExec_t exec;
  R(cudaGraphInstantiate(&exec, pg, 0));
  R(cudaGraphLaunch(exec, s2));
  R(cudaStreamSynchronize(s2));
  int got = -1;
  cudaMemcpy(&got, x, 4, cudaMemcpyDeviceToHost);
  printf("ALIVE clean replay x = %d (want 2)\n", got);
  return 0;
}
