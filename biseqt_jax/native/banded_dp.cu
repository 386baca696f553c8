// Banded affine-gap DP for NVIDIA Hopper, called from JAX through the
// XLA foreign function interface (biseqt_jax/ops/cuda_dp.py).
//
// Same contract as the lax.scan engine (biseqt_jax/ops/banded_dp.py):
// lane k of a row is diagonal d = dmax - k, so row i holds the cells
// (i, j = i - dmax + k); the four ModeFlags; per-pair band start and
// effective width; direction bytes in the engine's row layout
// [B, LS, W] (bits 0-1 H source, bit 2 E extend, bit 3 F extend), walked
// by native.traceback_batch.  Scores run in int32: the wrapper sends only
// integer-valued substitution and gap scores here, which the float32
// engine sums exactly too, so scores, end cells and live direction bytes
// agree with it bit for bit.
//
// Layout: one thread block per pair, one warp per 128 band lanes, four
// consecutive lanes per thread, H and F of the previous row in
// registers.  A row's dependencies are
//   diag (i-1, j-1): same lane, previous row (a register);
//   up   (i-1, j):   lane k+1, previous row (a register or a shuffle);
//   left (i, j-1):   lane k-1, same row — the affine E chain, solved as
//                    E[k] = ge*k + max_{m<k} (H_pre[m] + go + ge - ge*(m+1)),
//                    a max-scan: within the thread, by warp shuffles,
//                    and across warps through shared memory with one
//                    block barrier per row.
// The substitution table lives in shared memory, so any alphabet up to
// 32 letters (BLOSUM62 included) costs one shared load per cell.  Rows
// are written as one 32-bit store per thread, coalesced across the warp.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -I <jax.ffi.include_dir()>

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int NEG_I = -(1 << 30);   // the engine's NEG in integer units
constexpr int DEAD = -(1 << 29);    // anything below is derived from NEG
constexpr int OFF_BAND = 0x3fffffff;
constexpr int LANES = 4;            // band lanes per thread
constexpr int WARP_LANES = 32 * LANES;
constexpr int MAX_W = 2048;
constexpr int MAX_A = 32;
constexpr unsigned FULL = 0xffffffffu;

enum {
  FREE_START_EDGES = 1,
  LOCAL_START = 2,
  FREE_END_EDGES = 4,
  LOCAL_END = 8,
};

struct Best {
  int v, i, col, k;
};

// Tracker order of the lax engine: the larger score; on a tie the
// earlier row; within a row the j == LT column cell before the last
// row's cells; then the lower lane.
__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  if (a.v != b.v) return a.v > b.v;
  if (a.i != b.i) return a.i < b.i;
  if (a.col != b.col) return a.col > b.col;
  return a.k < b.k;
}

__device__ __forceinline__ Best shfl_best_down(const Best& x, int off) {
  Best y;
  y.v = __shfl_down_sync(FULL, x.v, off);
  y.i = __shfl_down_sync(FULL, x.i, off);
  y.col = __shfl_down_sync(FULL, x.col, off);
  y.k = __shfl_down_sync(FULL, x.k, off);
  return y;
}

__device__ __forceinline__ int live(int h) { return h > DEAD ? h : NEG_I; }

template <bool DIRS>
__global__ void __launch_bounds__(MAX_W / LANES)
banded_dp_kernel(const int8_t* __restrict__ s, const int8_t* __restrict__ t,
                 const int32_t* __restrict__ s_lens,
                 const int32_t* __restrict__ t_lens,
                 const int32_t* __restrict__ dmins,
                 const int32_t* __restrict__ w_effs,
                 const int32_t* __restrict__ subst, int A, int LS, int LT,
                 int W, int go, int ge, int flags, int32_t* score_out,
                 int32_t* end_i_out, int32_t* end_j_out, uint8_t* dirs) {
  extern __shared__ int smem[];
  const int NW = W / WARP_LANES;
  int* sub_sm = smem;              // [A, A]
  int* agg = sub_sm + A * A;       // [2][NW] warp max of the scan input
  int* bnd_h = agg + 2 * NW;       // [2][NW] first lane's H_pre
  int* bnd_f = bnd_h + 2 * NW;     // [2][NW] first lane's F
  int* last_p = bnd_f + 2 * NW;    // [2][NW] warp-local P of the last lane
  int* red = last_p + 2 * NW;      // [4][NW] final reduction

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int l = tid & 31;
  for (int x = tid; x < A * A; x += blockDim.x) sub_sm[x] = subst[x];
  __syncthreads();

  const int sl = min(max(s_lens[b], 0), LS);
  const int tl = min(max(t_lens[b], 0), LT);
  const int dmax = dmins[b] + W - 1;
  const int weff = w_effs[b];
  const int8_t* sb = s + (size_t)b * LS;
  const int8_t* tb = t + (size_t)b * LT;
  const int goe = go + ge;
  const bool lstart = flags & LOCAL_START;
  const bool fstart = flags & FREE_START_EDGES;
  const bool lend = flags & LOCAL_END;
  const bool fend = (flags & FREE_END_EDGES) && !lend;

  // band frame: lane k of row i reads T[i - 1 + k - dmax]
  auto tchar = [&](int y) -> uint32_t {
    const int idx = y - dmax;
    const int c = (idx >= 0 && idx < tl) ? (int)tb[idx] : 0;
    return (uint32_t)min(max(c, 0), A - 1);
  };
  // row 0: the empty origin prefix against T[:j]
  auto init_h = [&](int k) -> int {
    const int j = k - dmax;
    if (k >= weff || j < 0 || j > tl) return NEG_I;
    if (lstart || fstart || j == 0) return 0;
    return go + ge * j;
  };

  const int k0 = tid * LANES;
  int H[LANES], F[LANES], vlo[LANES], cb[LANES], ce[LANES];
  Best best[LANES];
  uint32_t tw = 0;  // packed band-frame T codes of this thread's lanes
#pragma unroll
  for (int q = 0; q < LANES; ++q) {
    const int k = k0 + q;
    // cell (i, k) is in the matrix iff 0 <= i - vlo[q] <= tl
    vlo[q] = k < weff ? dmax - k : OFF_BAND;
    cb[q] = goe - ge * (k + 1);
    ce[q] = ge * k;
    H[q] = init_h(k);
    F[q] = NEG_I;
    tw |= tchar(k) << (8 * q);
    best[q] = Best{NEG_I, 0, 0, k};
    const int v = live(H[q]);
    if (lend && v > best[q].v) best[q].v = v;
    if (fend && -vlo[q] == tl && v > best[q].v) {
      best[q].v = v;
      best[q].col = 1;
    }
  }
  // H and F of the next warp's first lane in the previous row
  int nb_h = NEG_I, nb_f = NEG_I;
  if (w + 1 < NW) nb_h = init_h((w + 1) * WARP_LANES);

  for (int i = 1; i <= sl; ++i) {
    const int par = (i & 1) * NW;
    const int* srow = sub_sm + min(max((int)sb[i - 1], 0), A - 1) * A;
    int h_dn = __shfl_down_sync(FULL, H[0], 1);
    int f_dn = __shfl_down_sync(FULL, F[0], 1);
    if (l == 31) {
      h_dn = nb_h;
      f_dn = nb_f;
    }
    int diag[LANES], fn[LANES], fext[LANES], hp[LANES], rel[LANES];
    int r[LANES];  // inclusive thread-local max of the scan input
#pragma unroll
    for (int q = 0; q < LANES; ++q) {
      const int hu = q + 1 < LANES ? H[q + 1] : h_dn;
      const int fu = q + 1 < LANES ? F[q + 1] : f_dn;
      diag[q] = H[q] + srow[(tw >> (8 * q)) & 0xff];
      fext[q] = fu + ge;
      fn[q] = __viaddmax_s32(hu, goe, fext[q]);
      int h = max(diag[q], fn[q]);
      rel[q] = i - vlo[q];  // == j
      if (lstart) h = max(h, 0);
      if (fstart && rel[q] == 0) h = max(h, 0);
      hp[q] = (unsigned)rel[q] <= (unsigned)tl ? h : NEG_I;
      const int bq = hp[q] + cb[q];
      r[q] = q ? max(r[q - 1], bq) : bq;
    }
    // warp scan of the thread maxima
    int inc = r[LANES - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, inc, off);
      if (l >= off) inc = max(inc, v);
    }
    int ex = __shfl_up_sync(FULL, inc, 1);
    if (l == 0) ex = NEG_I;
    // warp-local P at this thread's last lane, and the previous thread's
    const int x_last = max(ex, r[LANES - 2]);
    const int x_prev = __shfl_up_sync(FULL, x_last, 1);
    int carry = NEG_I;       // max of the scan input over earlier warps
    int carry_prev = NEG_I;  // ... over warps before the previous one
    int lastp_prev = NEG_I;
    if (NW > 1) {
      const int wtot = __shfl_sync(FULL, inc, 31);
      if (l == 0) {
        agg[par + w] = wtot;
        bnd_h[par + w] = hp[0];
        bnd_f[par + w] = fn[0];
      }
      if (l == 31) last_p[par + w] = x_last;
      __syncthreads();
      for (int u = 0; u < w; ++u) {
        carry_prev = carry;
        carry = max(carry, agg[par + u]);
      }
      if (w > 0) lastp_prev = last_p[par + w - 1];
      if (w + 1 < NW) {
        // finish the next warp's first lane: its H feeds this warp's
        // last lane in the next row
        const int k1 = (w + 1) * WARP_LANES;
        const int vlo1 = k1 < weff ? dmax - k1 : OFF_BAND;
        const bool valid1 = (unsigned)(i - vlo1) <= (unsigned)tl;
        const int e1 = max(carry, wtot) + ge * k1;
        nb_h = valid1 ? max(bnd_h[par + w + 1], e1) : NEG_I;
        nb_f = bnd_f[par + w + 1];
      }
    }
    const int p0 = max(carry, ex);
    int p_left = l > 0 ? max(carry, x_prev)
                       : (w > 0 ? max(carry_prev, lastp_prev) : NEG_I);
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < LANES; ++q) {
      const int p = q ? max(p0, r[q - 1]) : p0;
      const bool valid = (unsigned)rel[q] <= (unsigned)tl;
      const int e = valid ? p + ce[q] : NEG_I;
      const int h = valid ? max(hp[q], e) : NEG_I;
      if (DIRS) {
        uint32_t d = h == diag[q] ? 1u : (h == e ? 2u : 3u);
        if (lstart && h == 0 && diag[q] < 0) d = 0u;
        if (fstart && rel[q] == 0 && h == 0 && fn[q] < 0) d = 0u;
        d |= (uint32_t)(p == p_left) << 2;
        d |= (uint32_t)(fn[q] == fext[q]) << 3;
        word |= (valid ? d : 0u) << (8 * q);
      }
      p_left = p;
      H[q] = h;
      F[q] = fn[q];
      const int v = live(h);
      if (lend && v > best[q].v) {
        best[q].v = v;
        best[q].i = i;
      } else if (fend && rel[q] == tl && v > best[q].v) {
        best[q].v = v;
        best[q].i = i;
        best[q].col = 1;
      }
    }
    if (DIRS) {
      *reinterpret_cast<uint32_t*>(dirs + ((size_t)b * LS + (i - 1)) * W +
                                   k0) = word;
    }
    // slide the band-frame window one lane for row i + 1
    uint32_t nx = __shfl_down_sync(FULL, tw, 1);
    if (l == 31) nx = tchar(i + k0 + LANES - 1);
    tw = __funnelshift_r(tw, nx, 8);
  }
  if (DIRS) {
    for (int i = sl + 1; i <= LS; ++i) {
      *reinterpret_cast<uint32_t*>(dirs + ((size_t)b * LS + (i - 1)) * W +
                                   k0) = 0u;
    }
  }

  // candidates of the last row (overlap modes) or the corner cell (sl, tl)
  // on lane tl - sl + dmax (global modes, every thread reports the same
  // cell so the reduction keeps its value)
  Best mine{NEG_I, sl, 0, tl - sl + dmax};
#pragma unroll
  for (int q = 0; q < LANES; ++q) {
    if (lend || fend) {
      if (fend) {
        const int j = sl - vlo[q];
        const int v = (unsigned)j <= (unsigned)tl ? live(H[q]) : NEG_I;
        if (v > best[q].v) best[q] = Best{v, sl, j == tl, k0 + q};
      }
      if (q == 0 || better(best[q], mine)) mine = best[q];
    } else if (k0 + q == mine.k) {
      mine.v = live(H[q]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Best o = shfl_best_down(mine, off);
    if (l + off < 32 && better(o, mine)) mine = o;
  }
  if (NW > 1) {
    if (l == 0) {
      red[w] = mine.v;
      red[NW + w] = mine.i;
      red[2 * NW + w] = mine.col;
      red[3 * NW + w] = mine.k;
    }
    __syncthreads();
    if (tid == 0) {
      for (int u = 1; u < NW; ++u) {
        const Best o{red[u], red[NW + u], red[2 * NW + u], red[3 * NW + u]};
        if (better(o, mine)) mine = o;
      }
    }
  }
  if (tid == 0) {
    score_out[b] = mine.v;
    end_i_out[b] = mine.i;
    end_j_out[b] = mine.i - dmax + mine.k;
  }
}

ffi::Error BandedDpImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> s,
                        ffi::Buffer<ffi::S8> t, ffi::Buffer<ffi::S32> s_lens,
                        ffi::Buffer<ffi::S32> t_lens,
                        ffi::Buffer<ffi::S32> dmin,
                        ffi::Buffer<ffi::S32> w_eff,
                        ffi::Buffer<ffi::S32> subst, int32_t W, int32_t go,
                        int32_t ge, int32_t flags,
                        ffi::ResultBuffer<ffi::S32> score,
                        ffi::ResultBuffer<ffi::S32> end_i,
                        ffi::ResultBuffer<ffi::S32> end_j,
                        ffi::ResultBuffer<ffi::U8> dirs) {
  const auto sd = s.dimensions();
  const auto td = t.dimensions();
  const auto ad = subst.dimensions();
  if (sd.size() != 2 || td.size() != 2 || ad.size() != 2)
    return ffi::Error::InvalidArgument("banded_dp: bad input ranks");
  const int64_t B = sd[0], LS = sd[1], LT = td[1];
  const int64_t A = ad[0];
  if (td[0] != B || s_lens.element_count() != (size_t)B ||
      t_lens.element_count() != (size_t)B ||
      dmin.element_count() != (size_t)B ||
      w_eff.element_count() != (size_t)B || ad[1] != A)
    return ffi::Error::InvalidArgument("banded_dp: inconsistent shapes");
  if (W <= 0 || W % WARP_LANES != 0 || W > MAX_W || A < 1 || A > MAX_A)
    return ffi::Error::InvalidArgument(
        "banded_dp: W must be a multiple of 128 up to 2048 and A <= 32");
  const bool with_dirs = dirs->element_count() != 0;
  if (with_dirs && dirs->element_count() != (size_t)(B * LS * W))
    return ffi::Error::InvalidArgument("banded_dp: dirs must be [B, LS, W]");
  if (B == 0) return ffi::Error::Success();
  const int NW = W / WARP_LANES;
  const size_t smem = sizeof(int) * (A * A + 12 * NW);
  const dim3 grid((unsigned)B), block((unsigned)(NW * 32));
  if (with_dirs) {
    banded_dp_kernel<true><<<grid, block, smem, stream>>>(
        s.typed_data(), t.typed_data(), s_lens.typed_data(),
        t_lens.typed_data(), dmin.typed_data(), w_eff.typed_data(),
        subst.typed_data(), (int)A, (int)LS, (int)LT, W, go, ge, flags,
        score->typed_data(), end_i->typed_data(), end_j->typed_data(),
        dirs->typed_data());
  } else {
    banded_dp_kernel<false><<<grid, block, smem, stream>>>(
        s.typed_data(), t.typed_data(), s_lens.typed_data(),
        t_lens.typed_data(), dmin.typed_data(), w_eff.typed_data(),
        subst.typed_data(), (int)A, (int)LS, (int)LT, W, go, ge, flags,
        score->typed_data(), end_i->typed_data(), end_j->typed_data(),
        nullptr);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(BiseqtBandedDp, BandedDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("W")
                                  .Attr<int32_t>("go")
                                  .Attr<int32_t>("ge")
                                  .Attr<int32_t>("flags")
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>());
