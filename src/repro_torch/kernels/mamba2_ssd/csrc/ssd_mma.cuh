// TF32 tensor-core products with a three-term split and cp.async staging,
// shared by K5's forward (mamba2_ssd.cu) and backward (mamba2_ssd_bwd.cu)
// kernels: the helpers of kernels/csrc/tf32x3.cuh (shared with K1's
// float32 path and K4), named in this namespace, and K5's constants.
// ops.py hashes both headers into both libraries' names, so an edit to
// either rebuilds both.
//
// Each product runs on mma.sync m16n8k8 in TF32 with every operand split
// as a = hi + lo and taken as hi*lo + lo*hi + hi*hi with fp32
// accumulation, the cross terms in an accumulator of their own (mma3).
// Plain TF32 keeps 11 significant bits, an error near 1e-3 on sums of a
// few dozen terms against a tolerance of 1e-4; the split's dropped terms
// are about 2^-21 of each product.

#pragma once

#include "tf32x3.cuh"

namespace ssd {

constexpr int kChunk = 32;      // steps per chunk (ref.CHUNK)
constexpr unsigned kAll = 0xffffffffu;

using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::ld2;
using tf32x3::ld4;
using tf32x3::mma3;
using tf32x3::mma_tf32;
using tf32x3::split;
using tf32x3::split_a;
using tf32x3::tf32_rna;

}  // namespace ssd
