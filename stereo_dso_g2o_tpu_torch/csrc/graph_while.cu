// Device-side loops and branches for a captured CUDA graph: the port's
// lax.while_loop and lax.cond.
//
// The JAX package runs each level of the tracker's LM as a lax.while_loop
// inside one XLA program (stereo_dso_g2o_tpu/ops/tracker_ops.py, lm_level),
// and its retry ladder as a lax.cond (frontend/frame_step.py): the device
// decides how many trips run, and whether the branch does. A CUDA graph does
// the same with conditional nodes (CUDA >= 12.3): a WHILE node's body graph
// runs while the node's condition is set, an IF node's once if it is set,
// and a kernel of the graph sets the condition. runtime/program.py captures
// the frame program with PyTorch's graph API, which adds no WHILE node (and,
// in the PyTorch the card's machine has, no IF node either); these calls
// add both the way PyTorch adds its IF node
// (CUDAGraph::begin_capture_to_if_node):
//
//   sdso_cond_begin: on the capturing stream, a kernel that sets a new
//     condition from a device flag (CUDA evaluates a WHILE node's condition
//     before every trip, the first included), then the conditional node
//     after it; the stream's capture continues after the node, and
//     `body_stream` starts capturing into the node's body graph;
//   sdso_cond_end: for a WHILE node, on `body_stream`, the same kernel at
//     the end of the body (the trip has written the flag); then the end of
//     the body's capture.
//
// The kernel reads one byte and writes the condition: launch-bound, one
// thread, nothing to tune. Each call returns a cudaError_t (0: success).
//
// For the report and for a graph CUDA will not instantiate: sdso_graph_nodes
// counts a graph's nodes by type (a body's at its end, sdso_cond_end), and
// sdso_graph_fault instantiates a graph once more to name the node it
// fails at (its type and, for a kernel, the kernel's name).

#include <cuda_runtime.h>

#include <cstdio>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

extern "C" {

int sdso_cond_begin(void* stream, void* body_stream, const void* flag, int is_while,
                    unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the dependencies now end in the kernel just captured
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), body, nullptr,
                                      nullptr, 0, cudaStreamCaptureModeGlobal);
  if (err != cudaSuccess) return err;
  *handle_out = static_cast<unsigned long long>(handle);
  return cudaSuccess;
}

namespace {

constexpr int kTypes = 16;  // cudaGraphNodeType values counted

cudaError_t count_types(cudaGraph_t graph, unsigned long long* n_out,
                        unsigned long long* types_out) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return err;
  *n_out = n;
  if (types_out == nullptr || n == 0) return cudaSuccess;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    // a type this runtime cannot name (the conditional nodes, with some
    // CUDA versions) counts as the last one
    int k = cudaGraphNodeGetType(nodes[i], &type) == cudaSuccess ? static_cast<int>(type)
                                                                 : kTypes - 1;
    types_out[k < kTypes ? k : kTypes - 1] += 1;
  }
  cudaGetLastError();  // a type not named leaves no error behind
  delete[] nodes;
  return err;
}

}  // namespace

// flag: the WHILE node's, set again at the end of its body; null for an IF.
// types_out (kTypes counts): the body's nodes by type are added to it.
int sdso_cond_end(void* body_stream, const void* flag, unsigned long long handle,
                  unsigned long long* body_nodes_out, unsigned long long* types_out) {
  cudaStream_t s = static_cast<cudaStream_t>(body_stream);
  cudaError_t err = cudaSuccess;
  if (flag != nullptr) {
    set_condition<<<1, 1, 0, s>>>(static_cast<cudaGraphConditionalHandle>(handle),
                                  static_cast<const bool*>(flag));
    err = cudaGetLastError();
  }
  cudaGraph_t body;
  cudaError_t end = cudaStreamEndCapture(s, &body);
  if (err != cudaSuccess) return err;
  if (end != cudaSuccess) return end;
  return count_types(body, body_nodes_out, types_out);
}

// Nodes at the top level of a graph (a captured program kept with
// keep_graph=True), and by type (types_out: kTypes counts, added to).
int sdso_graph_nodes(void* graph, unsigned long long* n_out, unsigned long long* types_out) {
  return count_types(static_cast<cudaGraph_t>(graph), n_out, types_out);
}

// Instantiate `graph` once more; if CUDA refuses it, write what it
// says of the node at fault into `what` (its cudaGraphInstantiateResult,
// the node's type, a kernel node's function name). Returns the error.
int sdso_graph_fault(void* graph, char* what, int what_len) {
  cudaGraphExec_t exec;
  cudaGraphInstantiateParams params = {};
  cudaError_t err = cudaGraphInstantiateWithParams(&exec, static_cast<cudaGraph_t>(graph), &params);
  if (err == cudaSuccess) {
    cudaGraphExecDestroy(exec);
    snprintf(what, what_len, "instantiated");
    return 0;
  }
  int type = -1;
  const char* name = "";
  if (params.errNode_out != nullptr) {
    cudaGraphNodeType t;
    if (cudaGraphNodeGetType(params.errNode_out, &t) == cudaSuccess) {
      type = static_cast<int>(t);
      if (t == cudaGraphNodeTypeKernel) {
        cudaKernelNodeParams kp = {};
        if (cudaGraphKernelNodeGetParams(params.errNode_out, &kp) != cudaSuccess ||
            cudaFuncGetName(&name, kp.func) != cudaSuccess)
          name = "?";
      }
    }
  }
  cudaGetLastError();  // the refusal is reported here, not left pending
  snprintf(what, what_len, "cudaError %d, instantiate result %d, node type %d, kernel %s",
           static_cast<int>(err), static_cast<int>(params.result_out), type, name);
  return err;
}

}  // extern "C"
