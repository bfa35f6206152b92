// Kernel K1-flow in the flow's warp form (both passes on one warp of the
// chain's block, at d <= 32 and H <= 32 where its layout fits): its library.
// The body, the C interface and what was chosen, and why, are in
// nuts_fused_flow_posterior.cuh; today's form's library is
// nuts_fused_flow_posterior.cu.
#define NRT_FLOW_LIB_WARP 1
#include "nuts_fused_flow_posterior.cuh"
