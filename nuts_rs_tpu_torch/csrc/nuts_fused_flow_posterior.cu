// Kernel K1-flow in today's form of the flow (every thread of the chain's
// block; d > 32, H > 32, or a warp layout that does not fit): its library.
// The body, the C interface and what was chosen, and why, are in
// nuts_fused_flow_posterior.cuh; the warp form's library is
// nuts_fused_flow_warp_posterior.cu.
#define NRT_FLOW_LIB_WARP 0
#include "nuts_fused_flow_posterior.cuh"
