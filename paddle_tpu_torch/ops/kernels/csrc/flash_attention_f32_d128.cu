// Flash attention kernels for float inputs with head dim 128: one of the
// four builds of flash_attention.cuh (see there), compiled in parallel.
#define FLASH_DTYPE float
#define FLASH_HEAD_DIM 128
#include "flash_attention.cuh"
