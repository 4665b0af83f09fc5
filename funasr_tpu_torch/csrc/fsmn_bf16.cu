// Unit 1 of fsmn.cu (see its FSMN_UNIT note): the FSMN mode's bf16 forward
// instantiations (fsmn_memory_fwd_bf16, which fsmn_memory_fwd calls), compiled by an
// nvcc process of its own beside the other units.
#define FSMN_UNIT 1
#include "fsmn.cu"
