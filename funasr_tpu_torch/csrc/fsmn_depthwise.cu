// Unit 2 of fsmn.cu (see its FSMN_UNIT note): the plain depthwise mode's forward
// (fsmn_depthwise_fwd), compiled by an nvcc process of its own beside the other units.
#define FSMN_UNIT 2
#include "fsmn.cu"
