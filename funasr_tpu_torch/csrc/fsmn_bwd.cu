// Unit 3 of fsmn.cu (see its FSMN_UNIT note): the weight gradients
// (fsmn_memory_bwd_weight, fsmn_depthwise_bwd_weight), compiled by an nvcc process of its
// own beside the other units.
#define FSMN_UNIT 3
#include "fsmn.cu"
