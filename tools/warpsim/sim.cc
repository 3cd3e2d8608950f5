// The simulator's globals (cuda_bf16.h).
#include "cuda_runtime.h"

thread_local uint3 threadIdx, blockIdx;
dim3 gridDim;
alignas(1024) unsigned char smem_raw[kSimSmemBytes];
Sim sim;
