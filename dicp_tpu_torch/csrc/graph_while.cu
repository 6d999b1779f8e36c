// The device side of dicp_tpu_torch.jit's loops: a CUDA graph conditional
// WHILE node, the counterpart of the lax.while_loop that XLA compiles into
// the JAX package's jitted solve (dicp_tpu/registration.py::_run_while).
//
// Replaces no Pallas kernel.  It exists because a captured solve must leave
// its loop on the device: a host read of the convergence flag per
// iteration would stall the stream and cannot be captured at all.
//
// The node is built inside a stream capture that PyTorch began
// (torch.cuda.graph):
//
//   graph_while_begin(outer, body, flag, &handle)
//     reads the graph being captured on `outer` and its open dependencies,
//     creates a conditional handle in it, launches `set_condition` on
//     `outer` (the handle takes the flag's value before the node runs),
//     adds a WHILE node after that kernel, makes the node the capture's only
//     open dependency, and begins capturing `body` into the node's body
//     graph;
//   ... the loop body is enqueued on `body`, ending with ...
//   graph_while_set(handle, flag, body)
//     set_condition again, from the flag the body has just written;
//   graph_while_end(body)
//     ends the body's capture.
//
// At replay the node runs its body while the handle holds 1: the early exit
// is decided on the device, and the host waits for nothing.  `flag` is one
// byte, a torch.bool tensor on the card.
//
// What bounds it: one one-thread launch per iteration; nothing to speak of
// beside the body it gates.  Needs CUDA 12.4 (conditional nodes and
// cudaStreamBeginCaptureToGraph).  No allocation, no synchronisation.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps, size_t* ndeps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, nullptr, ndeps);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, ndeps);
#endif
}

}  // namespace

// Error codes beside cudaError_t's: the outer stream is not capturing.
constexpr int kNotCapturing = -1;

extern "C" int graph_while_begin(void* outer_stream, void* body_stream, const void* flag,
                                 unsigned long long* handle_out) {
  cudaStream_t outer = static_cast<cudaStream_t>(outer_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_info(outer, &status, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return kNotCapturing;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition<<<1, 1, 0, outer>>>(handle, static_cast<const bool*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the launch moved the capture's open dependencies to that kernel
  err = capture_info(outer, &status, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(outer, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(outer, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                      params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                      cudaStreamCaptureModeRelaxed);
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = handle;
  return 0;
}

extern "C" int graph_while_set(unsigned long long handle, const void* flag, void* stream) {
  set_condition<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), static_cast<const bool*>(flag));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int graph_while_end(void* body_stream) {
  cudaGraph_t body;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}
