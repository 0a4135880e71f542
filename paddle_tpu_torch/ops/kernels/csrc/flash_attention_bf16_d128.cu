// Flash attention kernels for __nv_bfloat16 inputs with head dim 128: one of the
// four builds of flash_attention.cuh (see there), compiled in parallel.
#define FLASH_DTYPE __nv_bfloat16
#define FLASH_HEAD_DIM 128
#include "flash_attention.cuh"
