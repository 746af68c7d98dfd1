// The bf16 instances of trunk_block.cu's kernels (K9f, K9b) and their
// entries mmtr_trunk_block_*_bf16: the same source, built as a translation
// unit of its own so that nvcc compiles them beside the float32 instances
// (one process a source, all started together) and the float32 unit
// compiles as it did.
#define TRUNK_BLOCK_BF16
#include "trunk_block.cu"
