// Kernel 16: a GeoIP table's columns gathered by looked-up row.
//
// Replaces logparser_tpu/geoip/device.py GeoDeviceTable.gather
// (jnp.asarray(arrays[column])[rows], an XLA gather), for any set of one
// table's columns in one launch: every column has the table's N = ranges + 1
// rows.  A negative row adds N once, then the row clamps into [0, N - 1]
// (the reference's gather rule); in 32 bits, since a row is int32 and N is
// positive, r + N cannot overflow.
//
// Design: a thread takes 4 consecutive rows (a quad), computes their
// clamped indices once, loads every column's 4 elements into registers
// (all of them in flight at once: a column read after the last would cost
// one more L2 or HBM round trip each), then stores them: one 16-byte store
// a 4-byte column (float32 coordinates, int32 vocabulary codes), two an
// 8-byte one (int64 ASN numbers).  The element size is the column's, the
// same for every thread, so the walks do not diverge.  Quads follow the
// outputs, which the wrapper allocates 16-byte aligned; ``rows`` comes as
// one 16-byte load where it is aligned too, else as four scalar loads, and
// the last B % 4 rows one by one.  The columns stay in global memory: a
// City table's 131,073 x 9 elements are a few MB, which L2 holds.  A grid
// of a few blocks per SM strides over the quads.  The column set is a
// by-value __grid_constant__ parameter, copied from the caller's host
// descriptor, so a launch needs no H2D copy; the kernel is instantiated
// per column count, so its walks unroll exactly.  On an H100 (PERF.md,
// tools/geo_gather_variants.json): a column loaded after the last
// (column_loop) took 0.0133 ms for the City table's 9 columns against
// 0.0102, one kernel for any count (all_13) 0.0071 for one column against
// 0.0067.
//
// Bound: bytes -- the 4-byte rows read once, every output written once,
// and the distinct elements of each column read.

#include "lp_common.cuh"

namespace {

constexpr int MAX_COLS = 13;   // the columns a GeoIP table extracts
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr int SMS = 132;

// One column of the caller's host descriptor.
struct GatherColumn {
  const void* column;
  void* out;
  long long elem_size;   // 4 or 8
};

struct GatherArgs {
  const void* column[MAX_COLS];
  void* out[MAX_COLS];
  const int32_t* rows;
  int n_cols, n, B;
  unsigned wide;   // bit c: column c has 8-byte elements
  bool rows_aligned;
};

__device__ __forceinline__ int clamp_row(int r, int n) {
  if (r < 0) r += n;
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

// NC: the columns this instantiation walks (a.n_cols of them are live):
// a launch takes the one of its column count, so the walks are unrolled
// exactly and a one-column call runs a one-column kernel.
template <int NC>
__global__ void __launch_bounds__(THREADS) geo_gather_kernel(const __grid_constant__ GatherArgs a) {
  const int quads = (a.B + 3) >> 2;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += gridDim.x * blockDim.x) {
    const int b0 = q << 2;
    const int k = min(4, a.B - b0);   // rows of this quad (4 but for the last)
    int r[4];
    if (k == 4 && a.rows_aligned) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(a.rows + b0));
      r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = j < k ? __ldg(a.rows + b0 + j) : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = clamp_row(r[j], a.n);
    // Every column's elements first, all in flight at once (a column is
    // one L2 or HBM round trip), then the stores.
    unsigned lo[NC][4], hi[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < a.n_cols) {
        if (a.wide >> c & 1u) {
          const auto* col = static_cast<const uint2*>(a.column[c]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint2 v = __ldg(col + r[j]);
            lo[c][j] = v.x;
            hi[c][j] = v.y;
          }
        } else {
          const auto* col = static_cast<const unsigned*>(a.column[c]);
#pragma unroll
          for (int j = 0; j < 4; ++j) lo[c][j] = __ldg(col + r[j]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < a.n_cols) {
        if (a.wide >> c & 1u) {
          auto* out = static_cast<uint2*>(a.out[c]) + b0;
          if (k == 4) {
            reinterpret_cast<uint4*>(out)[0] = make_uint4(lo[c][0], hi[c][0], lo[c][1], hi[c][1]);
            reinterpret_cast<uint4*>(out)[1] = make_uint4(lo[c][2], hi[c][2], lo[c][3], hi[c][3]);
          } else {
            for (int j = 0; j < k; ++j) out[j] = make_uint2(lo[c][j], hi[c][j]);
          }
        } else {
          auto* out = static_cast<unsigned*>(a.out[c]) + b0;
          if (k == 4) {
            *reinterpret_cast<uint4*>(out) = make_uint4(lo[c][0], lo[c][1], lo[c][2], lo[c][3]);
          } else {
            for (int j = 0; j < k; ++j) out[j] = lo[c][j];
          }
        }
      }
    }
  }
}

using Kernel = void (*)(GatherArgs);
constexpr Kernel KERNELS[MAX_COLS] = {
    geo_gather_kernel<1>, geo_gather_kernel<2>, geo_gather_kernel<3>, geo_gather_kernel<4>,
    geo_gather_kernel<5>, geo_gather_kernel<6>, geo_gather_kernel<7>, geo_gather_kernel<8>,
    geo_gather_kernel<9>, geo_gather_kernel<10>, geo_gather_kernel<11>,
    geo_gather_kernel<12>, geo_gather_kernel<13>};

}  // namespace

// desc: n_cols GatherColumn entries in host memory, read before the launch
// returns; every column has n elements; rows [B] int32 on the device.
LP_EXPORT int lp_geo_gather(const void* desc, int n_cols, int n, const void* rows, int B,
                            void* stream) {
  if (n_cols < 1 || n_cols > MAX_COLS || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  GatherArgs a = {};
  const GatherColumn* cols = static_cast<const GatherColumn*>(desc);
  for (int c = 0; c < n_cols; ++c) {
    if (cols[c].elem_size != 4 && cols[c].elem_size != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(cols[c].out) & 15)   // the quads' 16-byte stores
      return static_cast<int>(cudaErrorInvalidValue);
    a.column[c] = cols[c].column;
    a.out[c] = cols[c].out;
    if (cols[c].elem_size == 8) a.wide |= 1u << c;
  }
  if (B <= 0) return 0;
  a.rows = static_cast<const int32_t*>(rows);
  a.n_cols = n_cols;
  a.n = n;
  a.B = B;
  a.rows_aligned = (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
  int blocks = lp::grid_for((B + 3) / 4, THREADS);
  if (blocks > SMS * BLOCKS_PER_SM) blocks = SMS * BLOCKS_PER_SM;
  KERNELS[n_cols - 1]<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_geo_gather_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
