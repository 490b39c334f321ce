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
//
//   capture_probe hostfunc <route>
// a host function inside a WHILE node's body (3 runs), each run adding one to
// a host counter: route tograph (cudaLaunchHostFunc captured straight into
// the node's body graph), child (captured into a graph of its own, added as
// a child graph node) or addnode (cudaGraphAddHostNode into the node's body
// graph beside the captured step kernel). Prints the CUDA runtime and driver
// versions, every call's result and, where the graph instantiated and ran,
// the host counter ("HOSTFUNC_RAN calls = 3") or HOSTFUNC_REFUSED.
//
//   capture_probe nested <shape> <route> <fault>
// conditional nodes inside conditional bodies: shape w1i, w2i, w3i (a WHILE
// node of 4 runs holding a chain of 1, 2 or 3 IF nodes, depths 2-4; IF level
// k taken where the loop's counter is >= k) or wiw (WHILE > IF > WHILE, the
// inner WHILE of 2 runs); route child (every body captured as a graph of its
// own and added as a child graph node), tograph (every body captured straight
// into its node's body graph) or mixed (bodies that hold nodes to-graph, the
// innermost body as a child); a fault (as above) in the innermost body's
// capture. Each body adds one to its level's word and the innermost body
// adds its IF predicate to a counter word (a draw advanced times its
// predicate). Prints the capture and instantiation seconds, the top-level
// node count, the words after one launch against the expected ones
// ("NESTED_OK"), or, after a fault, how the captures ended; then a clean
// nested capture (route mixed) on new streams ("ALIVE").
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

int nested_main(int argc, char** argv);
int host_main(int argc, char** argv);

int main(int argc, char** argv) {
  if (argc >= 2 && !strcmp(argv[1], "nested")) return nested_main(argc, argv);
  if (argc >= 2 && !strcmp(argv[1], "hostfunc")) return host_main(argc, argv);
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

// ---------------------------------------------------------------------------
// Nested conditional nodes.
// ---------------------------------------------------------------------------
#include <chrono>

namespace nested {

__global__ void step_while(int* left, int* word, bool* p) {
  left[0] -= 1;
  word[0] += 1;
  *p = left[0] > 0;
}
__global__ void set_ge(const int* left, int k, bool* p) { *p = left[0] >= k; }
__global__ void add_word(int* word) { word[0] += 1; }
__global__ void add_pred(int* counter, const bool* p) { counter[0] += *p ? 1 : 0; }
__global__ void set_inner(int* inner, bool* p) {
  inner[0] = 2;
  *p = true;
}

struct Ctx {
  int route;  // 0 child, 1 tograph, 2 mixed
  const char* fault;
  int levels;  // IF levels under the WHILE (w1i..w3i), or 0 for wiw
  bool wiw;
  cudaStream_t streams[8];
  int *left, *inner, *words, *counter, *host;
  bool* preds;  // [0] outer WHILE, [1..3] IF levels, [4] inner WHILE
  bool failed;
  cudaGraph_t body_graphs[8];
  bool child[8];
};

static bool want_child(const Ctx& c, bool leaf) {
  return c.route == 0 || (c.route == 2 && leaf);
}

// Adds a conditional node after `parent`'s work and starts the capture of its
// body on `body`; returns the handle.
static cudaGraphConditionalHandle begin_node(Ctx& c, int depth, cudaStream_t parent,
                                             cudaStream_t body, const bool* pred,
                                             bool is_while, bool leaf) {
  cudaStreamCaptureStatus st;
  cudaGraph_t graph;
  cudaStreamGetCaptureInfo(parent, &st, nullptr, &graph, nullptr, nullptr);
  cudaGraphConditionalHandle h = 0;
  cudaError_t e = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (e != cudaSuccess) R(e);
  set_cond<<<1, 1, 0, parent>>>(h, pred);
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaStreamGetCaptureInfo(parent, &st, nullptr, &graph, &deps, &n_deps);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = h;
  params.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) R(e);
  e = cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) R(e);
  c.body_graphs[depth] = params.conditional.phGraph_out[0];
  c.child[depth] = want_child(c, leaf);
  if (c.child[depth]) {
    e = cudaStreamBeginCapture(body, cudaStreamCaptureModeThreadLocal);
  } else {
    e = cudaStreamBeginCaptureToGraph(body, c.body_graphs[depth], nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  }
  if (e != cudaSuccess) R(e);
  return h;
}

// Ends the body's capture (a WHILE body's flag kernel at its end) and, on
// the child route, adds it to the node's body graph.
static cudaError_t end_node(Ctx& c, int depth, cudaStream_t body, cudaGraphConditionalHandle h,
                            const bool* pred, bool is_while) {
  if (is_while && !c.child[depth]) set_cond<<<1, 1, 0, body>>>(h, pred);
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaStreamEndCapture(body, &g);
  if (e != cudaSuccess) {
    printf("  depth %d: end capture -> %d %s\n", depth, (int)e, cudaGetErrorName(e));
    if (g != nullptr && c.child[depth]) cudaGraphDestroy(g);
    return e;
  }
  if (!c.child[depth]) return cudaSuccess;
  cudaGraphNode_t child;
  e = cudaGraphAddChildGraphNode(&child, c.body_graphs[depth], nullptr, 0, g);
  cudaGraphDestroy(g);
  if (e != cudaSuccess) {
    printf("  depth %d: cudaGraphAddChildGraphNode -> %d %s\n", depth, (int)e,
           cudaGetErrorName(e));
    return e;
  }
  if (is_while) {
    void* args[] = {&h, &pred};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(set_cond);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    cudaGraphNode_t flag;
    e = cudaGraphAddKernelNode(&flag, c.body_graphs[depth], &child, 1, &kp);
    if (e != cudaSuccess) R(e);
  }
  return e;
}

static void fault(Ctx& c, cudaStream_t s) {
  const char* f = c.fault;
  if (!strcmp(f, "none")) return;
  c.failed = true;
  if (!strcmp(f, "sync")) R(cudaStreamSynchronize(s));
  if (!strcmp(f, "pinned")) R(cudaMemcpyAsync(c.host, c.words, 4, cudaMemcpyDeviceToHost, s));
  if (!strcmp(f, "event")) {
    cudaEvent_t ev;
    cudaEventCreate(&ev);
    R(cudaEventRecord(ev, s));
    R(cudaEventSynchronize(ev));
  }
  if (!strcmp(f, "malloc")) {
    void* p = nullptr;
    R(cudaMalloc(&p, 256));
  }
  if (!strcmp(f, "devsync")) R(cudaDeviceSynchronize());
}

// IF level k (1-based) on stream k, holding level k + 1; the innermost body
// faults and counts its predicate.
static cudaError_t if_chain(Ctx& c, int k, cudaStream_t parent) {
  cudaStream_t s = c.streams[k];
  set_ge<<<1, 1, 0, parent>>>(c.left, k, c.preds + k);
  bool leaf = k == c.levels;
  cudaGraphConditionalHandle h = begin_node(c, k, parent, s, c.preds + k, false, leaf);
  add_word<<<1, 1, 0, s>>>(c.words + k);
  cudaError_t e = cudaSuccess;
  if (leaf) {
    add_pred<<<1, 1, 0, s>>>(c.counter, c.preds + k);
    fault(c, s);
  } else {
    e = if_chain(c, k + 1, s);
  }
  cudaError_t e2 = end_node(c, k, s, h, c.preds + k, false);
  return e != cudaSuccess ? e : e2;
}

// The capture status of the top-level stream and of each body stream, after
// the bodies' captures were ended innermost first.
static void report_statuses(Ctx& c, cudaStream_t top) {
  for (int d = 0; d < 6; ++d) {
    printf("  status depth %d: %s\n", d, status_name(d == 0 ? top : c.streams[d]));
  }
}

}  // namespace nested

int nested_main(int argc, char** argv) {
  using namespace nested;
  if (argc < 5) return 2;
  const char* shape = argv[2];
  Ctx c = {};
  c.route = !strcmp(argv[3], "child") ? 0 : !strcmp(argv[3], "tograph") ? 1 : 2;
  c.fault = argv[4];
  c.wiw = !strcmp(shape, "wiw");
  c.levels = c.wiw ? 1 : shape[1] - '0';
  printf("case nested %s %s %s\n", shape, argv[3], c.fault);
  cudaStream_t top;
  cudaStreamCreateWithFlags(&top, cudaStreamNonBlocking);
  for (int i = 0; i < 8; ++i) cudaStreamCreateWithFlags(&c.streams[i], cudaStreamNonBlocking);
  cudaMalloc(&c.left, 4);
  cudaMalloc(&c.inner, 4);
  cudaMalloc(&c.words, 8 * 4);
  cudaMalloc(&c.counter, 4);
  cudaMalloc(&c.preds, 8);
  cudaMallocHost(&c.host, 4);
  cudaMemset(c.words, 0, 8 * 4);
  cudaMemset(c.counter, 0, 4);
  cudaMemset(c.preds, 1, 8);
  int four = 4;
  cudaMemcpy(c.left, &four, 4, cudaMemcpyHostToDevice);
  cudaDeviceSynchronize();

  auto t0 = std::chrono::steady_clock::now();
  R(cudaStreamBeginCapture(top, cudaStreamCaptureModeGlobal));
  cudaStream_t s0 = c.streams[0];
  // The WHILE node (depth 0 body on stream 0), its predicate set true.
  cudaGraphConditionalHandle hw = begin_node(c, 0, top, s0, c.preds, true, false);
  step_while<<<1, 1, 0, s0>>>(c.left, c.words, c.preds);
  cudaError_t e;
  if (c.wiw) {
    cudaStream_t s1 = c.streams[1], s2 = c.streams[2];
    set_ge<<<1, 1, 0, s0>>>(c.left, 1, c.preds + 1);
    cudaGraphConditionalHandle hi = begin_node(c, 1, s0, s1, c.preds + 1, false, false);
    add_word<<<1, 1, 0, s1>>>(c.words + 1);
    set_inner<<<1, 1, 0, s1>>>(c.inner, c.preds + 4);
    cudaGraphConditionalHandle hin = begin_node(c, 2, s1, s2, c.preds + 4, true, true);
    step_while<<<1, 1, 0, s2>>>(c.inner, c.words + 2, c.preds + 4);
    add_pred<<<1, 1, 0, s2>>>(c.counter, c.preds + 4);
    fault(c, s2);
    cudaError_t e2 = end_node(c, 2, s2, hin, c.preds + 4, true);
    cudaError_t e1 = end_node(c, 1, s1, hi, c.preds + 1, false);
    e = e2 != cudaSuccess ? e2 : e1;
  } else {
    e = if_chain(c, 1, s0);
  }
  cudaError_t e0 = end_node(c, 0, s0, hw, c.preds, true);
  if (e == cudaSuccess) e = e0;
  report_statuses(c, top);
  cudaGraph_t graph = nullptr;
  cudaError_t et = cudaStreamEndCapture(top, &graph);
  printf("  top end capture -> %d %s, graph %p\n", (int)et, cudaGetErrorName(et),
         (void*)graph);
  double capture_s =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
  fflush(stdout);
  if (graph != nullptr && e == cudaSuccess && et == cudaSuccess && !c.failed) {
    size_t n = 0;
    cudaGraphGetNodes(graph, nullptr, &n);
    auto t1 = std::chrono::steady_clock::now();
    cudaGraphExec_t exec;
    cudaError_t ei = cudaGraphInstantiate(&exec, graph, 0);
    double inst_s =
        std::chrono::duration<double>(std::chrono::steady_clock::now() - t1).count();
    printf("  instantiate -> %d %s\n", (int)ei, cudaGetErrorName(ei));
    if (ei == cudaSuccess) {
      R(cudaGraphLaunch(exec, top));
      R(cudaStreamSynchronize(top));
      int w[8], counter = -1;
      cudaMemcpy(w, c.words, 32, cudaMemcpyDeviceToHost);
      cudaMemcpy(&counter, c.counter, 4, cudaMemcpyDeviceToHost);
      // Expected: the WHILE body 4 times (left 3, 2, 1, 0 after its step);
      // IF level k where left >= k: 4 - k times; wiw: the inner WHILE 2 runs
      // each of the 3 taken IF bodies, its predicate after its step true on
      // the first run only.
      int want[4] = {4, 0, 0, 0}, want_counter;
      if (c.wiw) {
        want[1] = 3;
        want[2] = 6;
        want_counter = 3;
      } else {
        for (int k = 1; k <= c.levels; ++k) want[k] = 4 - k;
        want_counter = want[c.levels];
      }
      bool ok = counter == want_counter;
      for (int k = 0; k < 4; ++k) ok = ok && w[k] == want[k];
      printf("NESTED_%s words %d %d %d %d (want %d %d %d %d) counter %d (want %d) "
             "top_nodes %zu capture_s %.6f instantiate_s %.6f\n",
             ok ? "OK" : "WRONG", w[0], w[1], w[2], w[3], want[0], want[1], want[2], want[3],
             counter, want_counter, n, capture_s, inst_s);
      cudaGraphExecDestroy(exec);
    }
  } else {
    printf("NESTED_FAILED capture error %d %s\n", (int)e, cudaGetErrorName(e));
  }
  if (graph != nullptr) cudaGraphDestroy(graph);
  R(cudaGetLastError());
  fflush(stdout);

  // Afterwards: a clean nested capture (route mixed, w2i) on new streams.
  Ctx d = {};
  d.route = 2;
  d.fault = "none";
  d.levels = 2;
  d.left = c.left;
  d.inner = c.inner;
  d.words = c.words;
  d.counter = c.counter;
  d.preds = c.preds;
  d.host = c.host;
  for (int i = 0; i < 8; ++i) cudaStreamCreateWithFlags(&d.streams[i], cudaStreamNonBlocking);
  cudaStream_t top2;
  cudaStreamCreateWithFlags(&top2, cudaStreamNonBlocking);
  cudaMemset(d.words, 0, 32);
  cudaMemset(d.counter, 0, 4);
  cudaMemset(d.preds, 1, 8);
  cudaMemcpy(d.left, &four, 4, cudaMemcpyHostToDevice);
  cudaDeviceSynchronize();
  R(cudaStreamBeginCapture(top2, cudaStreamCaptureModeGlobal));
  cudaGraphConditionalHandle h2 = begin_node(d, 0, top2, d.streams[0], d.preds, true, false);
  step_while<<<1, 1, 0, d.streams[0]>>>(d.left, d.words, d.preds);
  if_chain(d, 1, d.streams[0]);
  end_node(d, 0, d.streams[0], h2, d.preds, true);
  cudaGraph_t g2 = nullptr;
  R(cudaStreamEndCapture(top2, &g2));
  cudaGraphExec_t exec2;
  R(cudaGraphInstantiate(&exec2, g2, 0));
  R(cudaGraphLaunch(exec2, top2));
  R(cudaStreamSynchronize(top2));
  int w2[4];
  cudaMemcpy(w2, d.words, 16, cudaMemcpyDeviceToHost);
  printf("ALIVE clean nested replay words %d %d %d (want 4 3 2)\n", w2[0], w2[1], w2[2]);
  return 0;
}

// ---------------------------------------------------------------------------
// A host function inside a WHILE node's body.
// ---------------------------------------------------------------------------
static void CUDART_CB count_call(void* data) { ++*static_cast<int*>(data); }

int host_main(int argc, char** argv) {
  if (argc < 3) return 2;
  const char* route = argv[2];
  int runtime = 0, driver = 0;
  cudaRuntimeGetVersion(&runtime);
  cudaDriverGetVersion(&driver);
  printf("case hostfunc %s\n", route);
  printf("  CUDA runtime %d driver %d\n", runtime, driver);
  cudaStream_t parent, body;
  cudaStreamCreateWithFlags(&parent, cudaStreamNonBlocking);
  cudaStreamCreateWithFlags(&body, cudaStreamNonBlocking);
  int *x, *left;
  bool* pred;
  cudaMalloc(&x, 4);
  cudaMalloc(&left, 4);
  cudaMalloc(&pred, 1);
  cudaMemset(x, 0, 4);
  int three = 3;
  cudaMemcpy(left, &three, 4, cudaMemcpyHostToDevice);
  cudaMemset(pred, 1, 1);
  cudaDeviceSynchronize();
  static int calls = 0;

  R(cudaStreamBeginCapture(parent, cudaStreamCaptureModeThreadLocal));
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
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  R(cudaGraphAddNode(&node, graph, deps, n_deps, &params));
  R(cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies));
  cudaGraph_t node_body = params.conditional.phGraph_out[0];
  const bool child = !strcmp(route, "child");
  if (child) {
    R(cudaStreamBeginCapture(body, cudaStreamCaptureModeThreadLocal));
  } else {
    R(cudaStreamBeginCaptureToGraph(body, node_body, nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal));
  }
  step<<<1, 1, 0, body>>>(x, left, pred);
  if (strcmp(route, "addnode") != 0) R(cudaLaunchHostFunc(body, count_call, &calls));
  set_cond<<<1, 1, 0, body>>>(handle, pred);
  R(cudaGetLastError());
  cudaGraph_t bg = nullptr;
  R(cudaStreamEndCapture(body, &bg));
  if (child && bg) {
    cudaGraphNode_t cn;
    R(cudaGraphAddChildGraphNode(&cn, node_body, nullptr, 0, bg));
    cudaGraphDestroy(bg);
  }
  if (!strcmp(route, "addnode")) {
    cudaHostNodeParams hp = {};
    hp.fn = count_call;
    hp.userData = &calls;
    cudaGraphNode_t hn;
    R(cudaGraphAddHostNode(&hn, node_body, nullptr, 0, &hp));
  }
  cudaGraph_t pg = nullptr;
  R(cudaStreamEndCapture(parent, &pg));
  bool ran = false;
  if (pg) {
    cudaGraphExec_t exec;
    cudaError_t e = cudaGraphInstantiate(&exec, pg, 0);
    printf("  cudaGraphInstantiate -> %d %s\n", (int)e, cudaGetErrorName(e));
    if (e == cudaSuccess) {
      R(cudaGraphLaunch(exec, parent));
      cudaError_t s2 = cudaStreamSynchronize(parent);
      printf("  cudaStreamSynchronize -> %d %s\n", (int)s2, cudaGetErrorName(s2));
      int got = -1;
      cudaMemcpy(&got, x, 4, cudaMemcpyDeviceToHost);
      printf("  replay x = %d (want 6)\n", got);
      ran = s2 == cudaSuccess;
      cudaGraphExecDestroy(exec);
    }
    cudaGraphDestroy(pg);
  }
  if (ran) {
    printf("HOSTFUNC_RAN calls = %d (want 3)\n", calls);
  } else {
    printf("HOSTFUNC_REFUSED\n");
  }
  fflush(stdout);
  return 0;
}
