// ABEA (adaptive banded event alignment) for NVIDIA Hopper, called from
// JAX through the XLA foreign function interface (ops/abea_cuda.py).
//
// One warp per read.  A band holds BW=100 cells in a kmer-anchored
// layout (cell o of band bi is kmer ll_k+o, event ll_e-o), 4 cells per
// lane.  The two previous band rows live in registers; the lane-1 /
// lane+1 neighbours come from warp shuffles, and Suzuki's edge rule reads
// cells 0 and 99 by shuffle broadcast, so the whole band loop runs inside
// one launch with no shared memory and no block barrier.  Each band's
// 2-bit directions (25 bytes) and its lower-left event index (word 7) are
// written as one coalesced 32-byte record.  A second kernel walks the
// trace back, one warp per read: the warp stages a window of band
// records in shared memory and lane 0 follows the path through it.
//
// Arithmetic follows the NumPy oracle (ops/abea_ref.py, after the
// reference's src/align.c) operation for operation: f32 emissions with
// explicit round-to-nearest intrinsics (no FMA contraction), and the
// transition sums in double, rounded to f32 on store.  Per-read
// lp_stay/lp_step arrive as f32 (hi, lo) pairs whose double sum is the
// host's double value; lp_skip and lp_trim are double attributes.
//
// Output contract (shared with the XLA route in ops/abea.py): a ragged
// buffer of 2-bit walk directions, 4 per byte, read i's at
// flat[byte_off[i]:byte_off[i+1]] in walk order from the last kmer;
// start_e[i] (the walk's first event, or -1) and n[i] (walk length).

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int BW = 100;
constexpr int WARPS_PER_BLOCK = 4;
constexpr int WALK_WINDOW = 256;   // band records staged per warp
constexpr unsigned FULL = 0xffffffffu;
constexpr int FROM_D = 0, FROM_U = 1, FROM_L = 2;
constexpr int META_I = 5;   // ev_off, ev_len, rk_off, rk_len, band_off
constexpr int META_F = 6;   // scale, shift, stay_hi, stay_lo, step_hi, step_lo

__device__ __forceinline__ float emission(float ev, float4 kp, float scale,
                                          float shift) {
  // (LOG_INV_SQRT_2PI - log_stdv) + (-0.5*a)*a, a = (ev - gmean) / stdv
  const float gmean = __fadd_rn(__fmul_rn(scale, kp.x), shift);
  const float a = __fdiv_rn(__fsub_rn(ev, gmean), kp.y);
  return __fadd_rn(__fsub_rn(-0.918938f, kp.z),
                   __fmul_rn(__fmul_rn(-0.5f, a), a));
}

__global__ void abea_fill_kernel(const float* __restrict__ ev_pool,
                                 const float4* __restrict__ kparams,
                                 const int32_t* __restrict__ meta_i,
                                 const float* __restrict__ meta_f,
                                 int n_reads, double lp_skip, double lp_trim,
                                 uint32_t* __restrict__ trace,
                                 int32_t* __restrict__ start_e) {
  const int read = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int t = threadIdx.x & 31;
  if (read >= n_reads) return;   // uniform per warp
  const int32_t* mi = meta_i + META_I * read;
  const int ne = mi[1], nk = mi[3];
  if (ne <= 0 || nk <= 0) {
    if (t == 0) start_e[read] = -1;
    return;
  }
  const float* ev = ev_pool + mi[0];
  const float4* kp = kparams + mi[2];
  uint32_t* tr = trace + 8ll * mi[4];
  const float* mf = meta_f + META_F * read;
  const float scale = mf[0], shift = mf[1];
  const double lp_stay = __dadd_rn((double)mf[2], (double)mf[3]);
  const double lp_step = __dadd_rn((double)mf[4], (double)mf[5]);
  const float NEG = -INFINITY;
  const int n_bands = ne + nk + 2;

  // bands 0 and 1: the start cell (kmer -1, event -1) and the first trim
  // cell (kmer -1, event 0), both at cell 50
  const int half = BW / 2;
  int ll_e_p2 = half - 1, ll_k_p2 = -1 - half;     // band bi-2
  int ll_e_p = ll_e_p2 + 1, ll_k_p = ll_k_p2;      // band bi-1
  float q[4], p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool start = (4 * t + j) == half;
    q[j] = start ? 0.0f : NEG;
    p[j] = start ? (float)lp_trim : NEG;
  }
  if (t < 8) {
    // band 0: all FROM_D; band 1: FROM_U at cell 50 (byte 12, bits 4-5)
    tr[t] = (t == 7) ? (uint32_t)ll_e_p2 : 0u;
    tr[8 + t] = (t == 7) ? (uint32_t)ll_e_p : (t == 3 ? (FROM_U << 4) : 0u);
  }

  double best = -INFINITY;
  int best_e = -1;
  for (int bi = 2; bi < n_bands; ++bi) {
    // Suzuki's rule from the previous band's edge cells (0 and BW-1)
    const float ll = __shfl_sync(FULL, p[0], 0);
    const float ur = __shfl_sync(FULL, p[3], (BW - 1) / 4);
    const bool right = (ll == NEG && ur == NEG) ? (bi & 1) : (ll < ur);
    const int ll_e = right ? ll_e_p : ll_e_p + 1;
    const int ll_k = right ? ll_k_p + 1 : ll_k_p;
    const int s_diag = (ll_k - ll_k_p2) - 1;      // in {-1, 0, 1}

    // neighbours across lanes: cell 4t-1 and cell 4t+4
    float p_lo = __shfl_up_sync(FULL, p[3], 1);
    float p_hi = __shfl_down_sync(FULL, p[0], 1);
    float q_lo = __shfl_up_sync(FULL, q[3], 1);
    float q_hi = __shfl_down_sync(FULL, q[0], 1);
    if (t == 0) { p_lo = NEG; q_lo = NEG; }
    if (t == 31) { p_hi = NEG; q_hi = NEG; }
    const float P[6] = {p_lo, p[0], p[1], p[2], p[3], p_hi};
    const float Q[6] = {q_lo, q[0], q[1], q[2], q[3], q_hi};

    const int trim_off = -1 - ll_k;
    const int trim_e = ll_e - trim_off;
    const bool trim_ok = trim_off >= 0 && trim_off < BW && trim_e >= 0 &&
                         trim_e < ne;
    float row[4];
    uint32_t byte = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = 4 * t + j;
      const int e = ll_e - o, k = ll_k + o;
      // up = (k, e-1) in band bi-1; left = (k-1, e) in bi-1;
      // diag = (k-1, e-1) in bi-2 (offset algebra as in abea_ref)
      const float up = right ? P[j + 2] : P[j + 1];
      const float left = right ? P[j + 1] : P[j];
      const float diag = s_diag > 0 ? Q[j + 2] : (s_diag == 0 ? Q[j + 1]
                                                              : Q[j]);
      float r = NEG;
      int d = 0;
      if (o < BW && k >= 0 && k < nk && e >= 0 && e < ne) {
        const float em = emission(__ldg(ev + e), __ldg(kp + k), scale,
                                  shift);
        const float sd = (float)__dadd_rn(__dadd_rn((double)diag, lp_step),
                                          (double)em);
        const float su = (float)__dadd_rn(__dadd_rn((double)up, lp_stay),
                                          (double)em);
        const float sl = (float)__dadd_rn((double)left, lp_skip);
        r = sd;
        d = FROM_D;
        if (su >= r) { r = su; d = FROM_U; }
        if (sl >= r) { r = sl; d = FROM_L; }
      }
      if (trim_ok && o == trim_off) {
        r = (float)__dmul_rn(lp_trim, (double)(trim_e + 1));
        d = FROM_U;
      }
      row[j] = r;
      byte |= (uint32_t)d << (2 * j);
    }

    // backtrace start: the last-kmer cell plus the trim tail, first best
    // in ascending event order (src/align.c tie rule)
    const int off_lc = (nk - 1) - ll_k;
    const int e_lc = ll_e - off_lc;
    if (off_lc >= 0 && off_lc < BW && e_lc >= 0 && e_lc < ne) {
      const int jj = off_lc & 3;
      const float mine = jj == 0 ? row[0] : jj == 1 ? row[1]
                         : jj == 2 ? row[2] : row[3];
      const float v = __shfl_sync(FULL, mine, off_lc >> 2);
      const double s = __dadd_rn((double)v,
                                 __dmul_rn((double)(ne - e_lc), lp_trim));
      if (s > best) { best = s; best_e = e_lc; }
    }

    // 2-bit trace: lane t owns byte t; four lanes make one word
    uint32_t w = byte << (8 * (t & 3));
    w |= __shfl_xor_sync(FULL, w, 1);
    w |= __shfl_xor_sync(FULL, w, 2);
    if ((t & 3) == 0) {
      const int m = t >> 2;
      tr[8ll * bi + m] = (m == 7) ? (uint32_t)ll_e : w;
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) { q[j] = p[j]; p[j] = row[j]; }
    ll_k_p2 = ll_k_p;
    ll_e_p = ll_e;
    ll_k_p = ll_k;
  }
  if (t == 0) start_e[read] = best_e;
}

__global__ void abea_walk_kernel(const uint4* __restrict__ trace,
                                 const int32_t* __restrict__ meta_i,
                                 const int32_t* __restrict__ start_e,
                                 const int32_t* __restrict__ byte_off,
                                 int n_reads, uint8_t* __restrict__ flat,
                                 int32_t* __restrict__ n_out) {
  __shared__ uint4 win[WARPS_PER_BLOCK][2 * WALK_WINDOW];
  const int wib = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int read = blockIdx.x * WARPS_PER_BLOCK + wib;
  if (read >= n_reads) return;   // uniform per warp
  const int32_t* mi = meta_i + META_I * read;
  const int ne = mi[1], nk = mi[3];
  int e = start_e[read];
  int k = nk - 1;
  if (ne <= 0 || nk <= 0 || e < 0) {
    if (t == 0) n_out[read] = 0;
    return;
  }
  const uint4* tr = trace + 2ll * mi[4];
  uint8_t* out = flat + byte_off[read];
  uint4* w = win[wib];
  int n = 0;
  uint32_t acc = 0;
  while (k >= 0 && e >= 0) {
    const int hi = e + k + 2;
    const int lo = max(hi - WALK_WINDOW + 1, 0);
    for (int i = t; i < 2 * (hi - lo + 1); i += 32) w[i] = tr[2ll * lo + i];
    __syncwarp();
    if (t == 0) {
      while (k >= 0 && e >= 0) {
        const int bi = e + k + 2;
        if (bi < lo) break;
        const uint32_t* rec = reinterpret_cast<const uint32_t*>(
            &w[2 * (bi - lo)]);
        const int off = (int)rec[7] - e;
        if (off < 0 || off >= BW) { e = -1; break; }   // not a band cell
        const uint32_t d = (rec[off >> 4] >> (2 * (off & 15))) & 3u;
        acc |= d << (2 * (n & 3));
        if ((n & 3) == 3) { out[n >> 2] = (uint8_t)acc; acc = 0; }
        ++n;
        if (d != FROM_L) --e;
        if (d != FROM_U) --k;
      }
    }
    e = __shfl_sync(FULL, e, 0);
    k = __shfl_sync(FULL, k, 0);
    __syncwarp();
  }
  if (t == 0) {
    if (n & 3) out[n >> 2] = (uint8_t)acc;
    n_out[read] = n;
  }
}

ffi::Error AbeaAlignImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> ev_pool,
                         ffi::Buffer<ffi::F32> kparams,
                         ffi::Buffer<ffi::S32> meta_i,
                         ffi::Buffer<ffi::F32> meta_f,
                         ffi::Buffer<ffi::S32> byte_off, double lp_skip,
                         double lp_trim, ffi::ResultBuffer<ffi::U8> flat,
                         ffi::ResultBuffer<ffi::S32> start_e,
                         ffi::ResultBuffer<ffi::S32> n_out,
                         ffi::ResultBuffer<ffi::U32> trace) {
  const int n_reads = static_cast<int>(start_e->element_count());
  if (meta_i.element_count() != (size_t)META_I * n_reads ||
      meta_f.element_count() != (size_t)META_F * n_reads ||
      byte_off.element_count() != (size_t)n_reads + 1 ||
      trace->element_count() % 8 != 0) {
    return ffi::Error::InvalidArgument("abea_align: inconsistent shapes");
  }
  cudaMemsetAsync(flat->untyped_data(), 0, flat->size_bytes(), stream);
  if (n_reads > 0) {
    const int threads = 32 * WARPS_PER_BLOCK;
    const int blocks = (n_reads + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    abea_fill_kernel<<<blocks, threads, 0, stream>>>(
        ev_pool.typed_data(),
        reinterpret_cast<const float4*>(kparams.typed_data()),
        meta_i.typed_data(), meta_f.typed_data(), n_reads, lp_skip, lp_trim,
        trace->typed_data(), start_e->typed_data());
    abea_walk_kernel<<<blocks, threads, 0, stream>>>(
        reinterpret_cast<const uint4*>(trace->typed_data()),
        meta_i.typed_data(), start_e->typed_data(), byte_off.typed_data(),
        n_reads, flat->typed_data(), n_out->typed_data());
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    F5cAbeaAlign, AbeaAlignImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()   // ev_pool [Lp]
        .Arg<ffi::Buffer<ffi::F32>>()   // kparams [Lr, 4]
        .Arg<ffi::Buffer<ffi::S32>>()   // meta_i [B, 5]
        .Arg<ffi::Buffer<ffi::F32>>()   // meta_f [B, 6]
        .Arg<ffi::Buffer<ffi::S32>>()   // byte_off [B + 1]
        .Attr<double>("lp_skip")
        .Attr<double>("lp_trim")
        .Ret<ffi::Buffer<ffi::U8>>()    // flat [cap]
        .Ret<ffi::Buffer<ffi::S32>>()   // start_e [B]
        .Ret<ffi::Buffer<ffi::S32>>()   // n [B]
        .Ret<ffi::Buffer<ffi::U32>>()); // trace scratch [bands * 8]
