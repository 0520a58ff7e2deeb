// Kernel 16: a GeoIP column gathered by looked-up row.
//
// Replaces logparser_tpu/geoip/device.py GeoDeviceTable.gather
// (jnp.asarray(arrays[column])[rows], an XLA gather).  One thread per row:
// a negative row adds the column's length once, then the row clamps into
// [0, N - 1] (the reference's gather rule), and the element is copied.
// One source for every column type: the element moves as a 4-byte word
// (float32 coordinates, int32 vocabulary codes) or an 8-byte word (int64
// ASN numbers), chosen by the element size.
//
// Bound: bytes -- the 4-byte row in and one element out per row, plus the
// distinct elements read (at most the column).  A plain gather: the
// column's few MB stay in L2, so the rows and outputs set the time.

#include "lp_common.cuh"

namespace {

template <typename T>
__global__ void geo_gather_kernel(const T* __restrict__ column, long long n,
                                  const int32_t* __restrict__ rows, int B,
                                  T* __restrict__ out) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    long long r = rows[b];
    if (r < 0) r += n;
    r = r < 0 ? 0 : (r >= n ? n - 1 : r);
    out[b] = column[r];
  }
}

}  // namespace

LP_EXPORT int lp_geo_gather(const void* column, int n, int elem_size,
                            const void* rows, int B, void* out, void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  if (elem_size == 8) {
    geo_gather_kernel<<<lp::grid_for(B, threads), threads, 0, s>>>(
        static_cast<const uint64_t*>(column), n, r, B, static_cast<uint64_t*>(out));
  } else if (elem_size == 4) {
    geo_gather_kernel<<<lp::grid_for(B, threads), threads, 0, s>>>(
        static_cast<const uint32_t*>(column), n, r, B, static_cast<uint32_t*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_geo_gather_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
