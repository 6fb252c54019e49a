// The slasher's span-grid merge: span_update_grid.
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). The C entry
// launches on the stream it is given and returns cudaGetLastError(); it
// takes the constant-table pointer every entry takes and does not read it.
// What the kernel replaces in the JAX package, what bounds it on the card
// and what its design does about that is written beside its Python wrapper
// (gpu/spans.py span_update_grid).
//
// For row r with attestation (s, t) and grid epoch e = base + c,
// c in [0, 64):
//   new_min[r][c] = min(min[r][c], valid[r] && e < s ? t : INT32_UNSET)
//   new_max[r][c] = max(max[r][c], valid[r] && s < e <= t ? t : 0)
// in signed int32, out of place. One thread takes 4 consecutive epochs of
// one row through 16-byte int4 loads and stores; the 16 threads of a row
// read its s, t and valid (neighbouring threads, one cache line).
#include <cstdint>

#include <cuda_runtime.h>

#define SPAN_GRID_EPOCHS 64
#define SPAN_QUADS (SPAN_GRID_EPOCHS / 4)
#define INT32_UNSET 0x7FFFFFFF

__device__ __forceinline__ int span_min(int old, bool on, int t) {
  return min(old, on ? t : INT32_UNSET);
}

__device__ __forceinline__ int span_max(int old, bool on, int t) {
  return max(old, on ? t : 0);
}

__global__ void __launch_bounds__(256)
span_update_grid_kernel(const int4* __restrict__ min_block,
                        const int4* __restrict__ max_block,
                        const int32_t* __restrict__ src,
                        const int32_t* __restrict__ tgt,
                        const bool* __restrict__ valid, long long quads,
                        int base, int4* __restrict__ out_min,
                        int4* __restrict__ out_max) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  long long row = i / SPAN_QUADS;
  int e = base + (int)(i % SPAN_QUADS) * 4;
  int s = src[row], t = tgt[row];
  bool v = valid[row];
  int4 mn = min_block[i], mx = max_block[i];
  mn.x = span_min(mn.x, v && e < s, t);
  mn.y = span_min(mn.y, v && e + 1 < s, t);
  mn.z = span_min(mn.z, v && e + 2 < s, t);
  mn.w = span_min(mn.w, v && e + 3 < s, t);
  mx.x = span_max(mx.x, v && s < e && e <= t, t);
  mx.y = span_max(mx.y, v && s < e + 1 && e + 1 <= t, t);
  mx.z = span_max(mx.z, v && s < e + 2 && e + 2 <= t, t);
  mx.w = span_max(mx.w, v && s < e + 3 && e + 3 <= t, t);
  out_min[i] = mn;
  out_max[i] = mx;
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_span_update_grid(const int32_t* min_block, const int32_t* max_block,
                         const int32_t* src, const int32_t* tgt,
                         const bool* valid, int n, int base, int32_t* out_min,
                         int32_t* out_max, const uint32_t* K,
                         cudaStream_t stream) {
  (void)K;
  long long quads = (long long)n * SPAN_QUADS;
  if (n > 0)
    span_update_grid_kernel<<<(unsigned)((quads + 255) / 256), 256, 0,
                              stream>>>(
        reinterpret_cast<const int4*>(min_block),
        reinterpret_cast<const int4*>(max_block), src, tgt, valid, quads,
        base, reinterpret_cast<int4*>(out_min),
        reinterpret_cast<int4*>(out_max));
  return (int)cudaGetLastError();
}

}  // extern "C"
