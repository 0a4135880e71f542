// Flash attention kernels for float inputs with head dim 64: one of the
// four builds of flash_attention.cuh (see there), compiled in parallel.
#define FLASH_DTYPE float
#define FLASH_HEAD_DIM 64
#include "flash_attention.cuh"
