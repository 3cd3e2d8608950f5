// Stands in for <cudaTypedefs.h> in the lockstep simulator: the type of the
// driver entry point the GEMM looks up (cuda.h has the simulator's version).
#pragma once
#include "cuda.h"

typedef CUresult (*PFN_cuTensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*, const cuuint64_t*,
    const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
