// easi_apply's small body at 32 columns of B a CTA (easi_small.cuh).
#include "easi_small.cuh"

REPRO_EASI_SMALL_WIDTH(32)
