// The simulator's globals (cuda_bf16.h).
#include "cuda_runtime.h"

thread_local uint3 threadIdx, blockIdx;
dim3 gridDim;
thread_local unsigned char* smem_raw;
thread_local SimCta* sim_cta;
thread_local unsigned sim_passed;
thread_local bool sim_arrived;
alignas(1024) unsigned char sim_smem[kSimMaxCluster][kSimSmemBytes];
Sim sim;
