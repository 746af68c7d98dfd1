// The bf16 instances of flash_attn.cu's kernels (K5f, K5b, K5dq, K5dkv) and
// their entries mmtr_flash_*_bf16: the same source, built as a translation
// unit of its own so that nvcc compiles them beside the float32 instances
// (one process a source, all started together) instead of after them.
#define FLASH_ATTN_BF16
#include "flash_attn.cu"
