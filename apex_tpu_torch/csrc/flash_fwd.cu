// flash_fwd: blockwise online-softmax attention forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _fwd_pallas). Computes O = softmax(scale * Q K^T [+ bias] [+ causal mask])
// V and the per-row logsumexp, +inf on rows with no visible key, over
// q (n, sq, d), k/v (n, sk, d) in bf16 or fp32, every d % 8 == 0 from 8
// to 256 (each run at a body width W, flash_width.cuh), with an
// optional broadcast fp32 score bias (common.cuh::ScoreBias) added after
// the scale and before the masks, as the TPU kernel adds it, and optional
// packed-sequence segment ids (common.cuh::Segments) that mask a score
// whose query and key ids differ, as the causal mask masks it. A bias
// value is a finite score: only the masks make a row fully masked; with a
// (q_ids, kv_ids) pair, so does a query id that no key carries.
//
// Two bodies, chosen by the inputs' dtype (a route, not a fallback: a bf16
// launch that fails raises):
//
// bf16: tensor cores (flash_fwd_mma_kernel). What bounds it on the H100: at
// GPT's training shape (n = 96, sq = sk = 1024, d = 64, causal) the function
// moves 50.7 MB (q, k, v, o, lse) and does 12.9 GFLOP over the causal half,
// so its floor is the ~15 us of HBM traffic, the tensor-core floor (~13 us
// at 989 TFLOP/s) just under it; at the long-context shape (96 x 4096 x 4096
// with packed ids) the products over the visible pairs bound it. What holds
// this version above that: mma.sync (not wgmma) reaches a fraction of the
// bf16 peak, and the softmax's exp and the masks run on the fp32 pipes
// beside it. The design: one block of 4 warps per (batch-head, 64-row q
// tile), each warp owning 16 rows; the q tile is staged once and its A
// fragments kept in registers, the 64-key K/V tiles stream through a 2-stage
// cp.async ring in padded shared tiles (mma.cuh), S = Q K^T and O += P V run
// as m16n8k16 products with fp32 accumulation (S's 16-wide k chunks each
// into a fresh accumulator, so the tensor cores' truncation does not pile up
// across them: the scores stay within ~2^-23 |q| |k| of the plain version's
// fp32 sums), and the running (m, l, O) of a row live in the quad of lanes
// that holds it (max reduced with two shuffles). The bias is read at each
// score's global (b, h, row, col), masked scores go to kNegInf and their
// probabilities are zeroed explicitly, dropout hashes each score's global
// (bh, row, col) as common.cuh does, and the probabilities (unnormalized, as
// the TPU kernel's) are rounded to bf16 while they are packed as the A
// fragment of P V. Tiles wholly above the causal diagonal are skipped for
// the block and for each warp, and, with segment ids, a (q tile, key tile)
// pair whose id ranges are disjoint (mma.cuh:: tiles_meet; the ranges come
// from the wrapper) is never loaded: an exact no-op, since every score in it
// is masked. Blocks run heaviest first (the last q tiles see the most keys
// under the causal mask).
//
// fp32: the SIMT body (flash_fwd_kernel), exact fp32 products, which the
// fp32 checks' limits need (TF32 would break them). What bounds it: its
// products run on the fp32 pipes out of shared memory, some two orders of
// magnitude above the floor. The design: each block owns one (n, 64-row q
// tile) and walks 32-key k/v tiles staged in shared memory (fp32, k rows
// padded to d + 1 floats), the running (m, l, acc) of its rows in
// registers; each warp owns 8 interleaved rows, lane j scores key j, the
// warp reduces max and sum with shuffles, and P V runs with lanes owning
// output dims and the probabilities broadcast by shuffle. It skips the
// tiles above the causal diagonal, but not those the ids hide.

#include "common.cuh"
#include "flash_width.cuh"
#include "mma.cuh"

namespace apex_port {
namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 32;        // keys per k/v tile: one per lane
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBQ / kWarps;

template <int W, bool kSeg>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (kBQ * W + kBK * (W + 1) + kBK * W) +
         (kSeg ? sizeof(int) * kBK : 0);
}

// Element (r, c) of a row-major slice of run-time width d, widened to
// fp32, or 0 for a row past len or a column past d (the fixed widths keep
// their own loads below)
template <typename T>
__device__ __forceinline__ float load_elem(const T* src, int r, int c,
                                           int len, int d) {
  return r < len && c < d ? to_float(src[static_cast<size_t>(r) * d + c])
                          : 0.f;
}

template <typename T, int W, bool kDyn, bool kSeg>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int d, int causal,
                 float scale, ScoreBias bias, Segments seg, Dropout dr) {
  // output dims per lane (lane + 32 dd); at a W not a multiple of 32 the
  // last one's upper lanes hold none
  constexpr int kDPL = (W + 31) / 32;
  constexpr bool kRagged = W % 32 != 0;
  if constexpr (!kDyn) d = W;
  extern __shared__ float smem[];
  float* qs = smem;                     // kBQ x W
  float* ks = qs + kBQ * W;             // kBK x (W + 1)
  float* vs = ks + kBK * (W + 1);       // kBK x W
  int* kid = reinterpret_cast<int*>(vs + kBK * W);  // kBK key ids (kSeg)

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int offset = sk - sq;  // causal: col <= row + offset is visible
  const T* qb = q + static_cast<size_t>(bh) * sq * d;
  const T* kb = k + static_cast<size_t>(bh) * sk * d;
  const T* vb = v + static_cast<size_t>(bh) * sk * d;
  const uint32_t bh_key = dropout_bh_key(dr, bh);

  if constexpr (kDyn) {
    for (int i = tid; i < kBQ * W; i += kWarps * 32)
      qs[i] = load_elem<T>(qb, q0 + i / W, i % W, sq, d);
  } else {
    for (int i = tid; i < kBQ * W; i += kWarps * 32) {
      const int r = i / W;
      qs[i] = (q0 + r < sq) ? to_float(qb[static_cast<size_t>(q0) * W + i])
                            : 0.f;
    }
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPL];
  int qid[kRowsPerWarp];  // the rows' query ids (kSeg)
  const int* kv_ids = kSeg ? seg_row(seg.kv, seg.heads, bh, sk) : nullptr;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (kSeg) {
      const int row = q0 + rr * kWarps + warp;
      qid[rr] = row < sq ? seg_row(seg.q, seg.heads, bh, sq)[row] : 0;
    }
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) acc[rr][dd] = 0.f;
  }

  // keys past kv_end are above the diagonal for every row of the tile
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kBQ + offset);

  for (int j0 = 0; j0 < kv_end; j0 += kBK) {
    __syncthreads();  // the previous tile is consumed; the q tile is staged
    for (int i = tid; i < kBK * W; i += kWarps * 32) {
      const int r = i / W;
      const int c = i % W;
      if constexpr (kDyn) {
        ks[r * (W + 1) + c] = load_elem<T>(kb, j0 + r, c, sk, d);
        vs[r * W + c] = load_elem<T>(vb, j0 + r, c, sk, d);
      } else {
        const bool in = j0 + r < sk;
        const size_t g = static_cast<size_t>(j0 + r) * W + c;
        ks[r * (W + 1) + c] = in ? to_float(kb[g]) : 0.f;
        vs[r * W + c] = in ? to_float(vb[g]) : 0.f;
      }
    }
    if (kSeg && tid < kBK) kid[tid] = j0 + tid < sk ? kv_ids[j0 + tid] : 0;
    __syncthreads();
    const int col = j0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = rr * kWarps + warp;  // interleaved: balances causal work
      const int row = q0 + r;
      // both conditions are uniform across the warp
      if (row >= sq) continue;
      if (causal && j0 > row + offset) continue;
      const float* qr = qs + r * W;
      const float* kr = ks + lane * (W + 1);
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < W; ++c) s = fmaf(qr[c], kr[c], s);
      s *= scale;
      if (bias.p != nullptr && col < sk) s += bias_row(bias, bh, row)[col];
      bool valid = col < sk && (!causal || col <= row + offset);
      if (kSeg) valid = valid && qid[rr] == kid[lane];
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(s));
      // a row with no visible key so far has m_new == kNegInf and
      // exp(s - m_new) == 1 on masked entries: zero them explicitly
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p);
      m[rr] = m_new;
      float pd = p;
      if (dr.on)
        pd = dropout_keep(bh_key, row, col, dr.thresh) ? p * dr.inv_keep : 0.f;
      const float pr = round_to<T>(pd);
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) acc[rr][dd] *= corr;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(kFullMask, pr, j);
        const float* vr = vs + j * W + lane;
#pragma unroll
        for (int dd = 0; dd < kDPL; ++dd)
          if (!kRagged || lane + dd * 32 < W)
            acc[rr][dd] = fmaf(pj, vr[dd * 32], acc[rr][dd]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + rr * kWarps + warp;
    if (row >= sq) continue;
    const float safe_l = l[rr] == 0.f ? 1.f : l[rr];
    T* orow = o + (static_cast<size_t>(bh) * sq + row) * d;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd)
      if (!(kDyn || kRagged) || lane + dd * 32 < d)
        store_as(orow + lane + dd * 32, acc[rr][dd] / safe_l);
    if (lane == 0)
      lse[static_cast<size_t>(bh) * sq + row] =
          l[rr] == 0.f ? CUDART_INF_F : m[rr] + logf(safe_l);
  }
}

template <typename T, int W, bool kDyn, bool kSeg>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int n, int sq, int sk, int d, int causal,
                   float scale, ScoreBias bias, Segments seg, Dropout dr,
                   cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<W, kSeg>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, W, kDyn, kSeg>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, W, kDyn, kSeg><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, sk, d, causal, scale, bias, seg, dr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, int w, const void* q, const void* k,
                     const void* v, void* o, void* lse, int n, int sq,
                     int sk, int causal, float scale, ScoreBias bias,
                     Segments seg, Dropout dr, cudaStream_t stream) {
  return width::dispatch(d, w, [&](auto wc, auto dyn) {
    constexpr int W = decltype(wc)::value;
    constexpr bool kDyn = decltype(dyn)::value;
    return seg.q != nullptr
               ? launch<T, W, kDyn, true>(q, k, v, o, lse, n, sq, sk, d,
                                          causal, scale, bias, seg, dr,
                                          stream)
               : launch<T, W, kDyn, false>(q, k, v, o, lse, n, sq, sk, d,
                                           causal, scale, bias, seg, dr,
                                           stream);
  });
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core body
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBM = 64;  // q rows a block
constexpr int kBN = 64;  // keys a K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
static_assert(kBM == mma::kIdTile && kBN == mma::kIdTile,
              "the id ranges are per 64-position tile");

// the q tile and two stages of K and V tiles, padded rows
template <int W>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * 5 * kBM * mma::ld<W>();
}

// The tensor-core forward's body, W the body width, d the head dim (W
// itself without kDyn); flash_fwd_mma_kernel and flash_fwd_mma_kernel3
// below are its two launch configurations
template <int W, bool kDyn, bool kSeg>
__device__ __forceinline__ void fwd_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int sq, int sk, int d, int causal, float scale,
    ScoreBias bias, Segments seg, const int* __restrict__ q_rng,
    const int* __restrict__ kv_rng, Dropout dr) {
  constexpr int kLd = mma::ld<W>();
  constexpr int kKC = W / 16;  // k chunks of Q K^T
  constexpr int kDT = W / 8;   // 8-wide n tiles of O
  constexpr int kST = kBN / 8; // 8-wide n tiles of S
  if constexpr (!kDyn) d = W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kBM x kLd
  bf16* ks = qs + kBM * kLd;                     // 2 stages of kBN x kLd
  bf16* vs = ks + 2 * kBN * kLd;                 // 2 stages of kBN x kLd

  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heaviest first
  const int q0 = q_tile * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int rows[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};
  const int offset = sk - sq;  // causal: col <= row + offset is visible
  const size_t qbase = static_cast<size_t>(bh) * sq;
  const bf16* kb = k + static_cast<size_t>(bh) * sk * d;
  const bf16* vb = v + static_cast<size_t>(bh) * sk * d;
  const uint32_t bh_key = dropout_bh_key(dr, bh);

  // keys past kv_end are above the diagonal for every row of the tile
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kBM + offset);
  const int n_tiles = kv_end > 0 ? (kv_end + kBN - 1) / kBN : 0;
  const int* qr = nullptr;
  const int* kr = nullptr;
  if (kSeg) {
    const size_t b = bh / seg.heads;
    qr = q_rng + b * ((sq + kBM - 1) / kBM) * 2;
    kr = kv_rng + b * ((sk + kBN - 1) / kBN) * 2;
  }
  // the first key tile at or after j whose ids can meet the q tile's
  auto next_tile = [&](int j) {
    if (kSeg)
      while (j < n_tiles && !mma::tiles_meet(qr, q_tile, kr, j)) ++j;
    return j;
  };
  auto stage_kv = [&](int j, int st) {
    mma::stage_tile<W, kThreads, kDyn>(ks + st * kBN * kLd, kb, j * kBN, sk,
                                       d);
    mma::stage_tile<W, kThreads, kDyn>(vs + st * kBN * kLd, vb, j * kBN, sk,
                                       d);
  };

  mma::stage_tile<W, kThreads, kDyn>(qs, q + qbase * d, q0, sq, d);
  mma::cp_async_commit();
  int j = next_tile(0);
  if (j < n_tiles) stage_kv(j, 0);
  mma::cp_async_commit();

  int qid[2] = {0, 0};  // the rows' query ids (kSeg)
  const int* kv_ids = kSeg ? seg_row(seg.kv, seg.heads, bh, sk) : nullptr;
  const float* brow[2] = {nullptr, nullptr};  // the rows' bias rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    if (kSeg) qid[r] = seg_row(seg.q, seg.heads, bh, sq)[rows[r]];
    if (bias.p != nullptr) brow[r] = bias_row(bias, bh, rows[r]);
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's part of each row's sum
  float acc[kDT][4];
#pragma unroll
  for (int dn = 0; dn < kDT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  mma::cp_async_wait<1>();  // the q tile
  __syncthreads();
  uint32_t qf[kKC][4];  // the warp's 16 q rows as A fragments
#pragma unroll
  for (int kc = 0; kc < kKC; ++kc)
    mma::ldmatrix_x4(qf[kc], mma::frag_a_ptr<W>(qs, warp * 16, kc * 16,
                                                lane));

  int st = 0;
  while (j < n_tiles) {
    const int jn = next_tile(j + 1);
    if (jn < n_tiles) stage_kv(jn, st ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // tile j
    __syncthreads();
    const int j0 = j * kBN;
    // uniform across the warp: rows past sq, or every row above the tile
    const bool live = w0 < sq && !(causal && j0 > w0 + 15 + offset);
    if (live) {
      const bf16* kt = ks + st * kBN * kLd;
      const bf16* vt = vs + st * kBN * kLd;
      // S = Q K^T, each 16-wide k chunk into a fresh accumulator added to
      // the sum with a rounded fp32 add (the tensor cores truncate a sum
      // into its accumulator; chunk by chunk that bias would pile up, and
      // move the probabilities further from the plain version's)
      float s[kST][4];
#pragma unroll
      for (int nt = 0; nt < kST; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
#pragma unroll
        for (int np = 0; np < kST / 2; ++np) {
          uint32_t b[4];
          float c[2][4] = {};
          mma::ldmatrix_x4(b, mma::frag_bt_ptr<W>(kt, np * 16, kc * 16,
                                                  lane));
          mma::mma_16816(c[0], qf[kc], b[0], b[1]);
          mma::mma_16816(c[1], qf[kc], b[2], b[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[2 * np][e] += c[0][e];
            s[2 * np + 1][e] += c[1][e];
          }
        }
      }
      // masks are needed on the sk edge, on the diagonal and with ids
      const bool edge = j0 + kBN > sk ||
                        (causal && j0 + kBN - 1 > w0 + offset) || kSeg;
      uint32_t valid_bits = 0xffffffffu;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < kST; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int row = rows[r];
          const int col = j0 + nt * 8 + 2 * t + (e & 1);
          float x = s[nt][e] * scale;
          if (brow[r] != nullptr && col < sk) x += brow[r][col];
          if (edge) {
            bool valid = row < sq && col < sk &&
                         (!causal || col <= row + offset);
            if (kSeg) valid = valid && qid[r] == kv_ids[col];
            if (!valid) {
              valid_bits &= ~(1u << (nt * 4 + e));
              x = kNegInf;
            }
          }
          s[nt][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the row's four lanes share their maxima
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
        corr[r] = __expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int nt = 0; nt < kST; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          // a row with no visible key so far has m == kNegInf and
          // exp(s - m) == 1 on masked entries: zero them explicitly
          const float p = (valid_bits >> (nt * 4 + e)) & 1u
                              ? __expf(s[nt][e] - m[r]) : 0.f;
          l[r] += p;
          float pd = p;
          if (dr.on) {
            const int col = j0 + nt * 8 + 2 * t + (e & 1);
            pd = dropout_keep(bh_key, rows[r], col, dr.thresh)
                     ? p * dr.inv_keep : 0.f;
          }
          s[nt][e] = pd;
        }
      }
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        acc[dn][0] *= corr[0];
        acc[dn][1] *= corr[0];
        acc[dn][2] *= corr[1];
        acc[dn][3] *= corr[1];
      }
      // O += P V: P (rounded to bf16) as the A fragment, V as B through
      // ldmatrix.trans of its [key][d] tile
#pragma unroll
      for (int kc = 0; kc < kBN / 16; ++kc) {
        uint32_t a[4];
        mma::pack_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < W / 16; ++dp) {
          uint32_t b[4];
          mma::ldmatrix_x4_trans(b, mma::frag_a_ptr<W>(vt, kc * 16, dp * 16,
                                                       lane));
          mma::mma_16816(acc[2 * dp], a, b[0], b[1]);
          mma::mma_16816(acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
    j = jn;
    st ^= 1;
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
    const int row = rows[r];
    if (row >= sq) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    bf16* orow = o + (qbase + row) * d + 2 * t;
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn)
      if (!kDyn || dn * 8 < d)  // the first d columns
        *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8) =
            __floats2bfloat162_rn(acc[dn][2 * r] / safe_l,
                                  acc[dn][2 * r + 1] / safe_l);
    if (t == 0)
      lse[qbase + row] = l[r] == 0.f ? CUDART_INF_F : m[r] + logf(safe_l);
  }
}

template <int W, bool kDyn, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int d,
                     int causal, float scale, ScoreBias bias, Segments seg,
                     const int* __restrict__ q_rng,
                     const int* __restrict__ kv_rng, Dropout dr) {
  fwd_mma_body<W, kDyn, kSeg>(q, k, v, o, lse, sq, sk, d, causal, scale,
                              bias, seg, q_rng, kv_rng, dr);
}

// The body held to three blocks an SM, as the fixed width 64 reaches on its
// own: the launch at a run-time d at widths 64 to 96 (left alone, ptxas
// gave width 80 227 registers, two blocks, and made it slower than width
// 96 at 168; below 64 the bound only raised the count). A kernel of its
// own, since any explicit blocks-an-SM bound, 1 included, changes the
// fixed widths' code (width 64: 200 registers, not 168)
template <int W, bool kDyn, bool kSeg>
__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_mma_kernel3(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int d,
                      int causal, float scale, ScoreBias bias, Segments seg,
                      const int* __restrict__ q_rng,
                      const int* __restrict__ kv_rng, Dropout dr) {
  fwd_mma_body<W, kDyn, kSeg>(q, k, v, o, lse, sq, sk, d, causal, scale,
                              bias, seg, q_rng, kv_rng, dr);
}

template <int W, bool kDyn, bool kSeg>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int n, int sq, int sk, int d, int causal,
                   float scale, ScoreBias bias, Segments seg,
                   const int* q_rng, const int* kv_rng, Dropout dr,
                   cudaStream_t stream) {
  const auto kernel = [] {
    if constexpr (kDyn && W >= 64 && W <= 96)
      return flash_fwd_mma_kernel3<W, kDyn, kSeg>;
    else
      return flash_fwd_mma_kernel<W, kDyn, kSeg>;
  }();
  const size_t smem = smem_bytes<W>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (sq + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), sq, sk, d, causal, scale, bias, seg, q_rng,
      kv_rng, dr);
  return cudaGetLastError();
}

cudaError_t launch_d(int d, int w, const void* q, const void* k,
                     const void* v, void* o, void* lse, int n, int sq,
                     int sk, int causal, float scale, ScoreBias bias,
                     Segments seg, const int* q_rng, const int* kv_rng,
                     Dropout dr, cudaStream_t stream) {
  return width::dispatch(d, w, [&](auto wc, auto dyn) {
    constexpr int W = decltype(wc)::value;
    constexpr bool kDyn = decltype(dyn)::value;
    return seg.q != nullptr
               ? launch<W, kDyn, true>(q, k, v, o, lse, n, sq, sk, d, causal,
                                       scale, bias, seg, q_rng, kv_rng, dr,
                                       stream)
               : launch<W, kDyn, false>(q, k, v, o, lse, n, sq, sk, d,
                                        causal, scale, bias, seg, q_rng,
                                        kv_rng, dr, stream);
  });
}

}  // namespace tc

}  // namespace
}  // namespace apex_port

// C entry point, bound with ctypes, one a group of widths
// (flash_width.cuh: apex_flash_fwd_p<group>). d is the head dim and w its
// body width (_kernels.py::flash_width), which the group must hold. dtype:
// 0 fp32 (the SIMT body), 1 bf16 (the tensor-core body; q, k, v 16-byte
// aligned). `bias` is null or an
// fp32 bias read as common.cuh::ScoreBias with `heads` and the strides
// `sb`, `sh`, `sr`. `q_ids`/`kv_ids` are null or int32 segment ids
// (b, sq)/(b, sk) read as common.cuh::Segments with `seg_heads` heads per
// id row; with them, `q_rng`/`kv_rng` are their per-64-position-tile
// (min, max) ranges, int32 (b, ceil(sq / 64), 2)/(b, ceil(sk / 64), 2),
// which the bf16 body skips tile pairs by (mma.cuh::tiles_meet). Dropout
// is on iff `dropout`; then `seed`, `thresh` and `inv_keep` are as in
// common.cuh::Dropout. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int APEX_FLASH_ENTRY(apex_flash_fwd)(
    const void* q, const void* k, const void* v, void* o, void* lse, int n,
    int sq, int sk, int d, int w, int dtype, int causal, float scale,
    const void* bias, int heads, int sb, int sh, int sr, const void* q_ids,
    const void* kv_ids, int seg_heads, const void* q_rng, const void* kv_rng,
    int dropout, unsigned seed, int thresh, float inv_keep, void* stream) {
  using namespace apex_port;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScoreBias bi{static_cast<const float*>(bias), heads, sb, sh, sr};
  const Segments sg{static_cast<const int*>(q_ids),
                    static_cast<const int*>(kv_ids), seg_heads};
  const Dropout dr{dropout, seed, thresh, inv_keep};
  if (dtype == kFloat32)
    return launch_d<float>(d, w, q, k, v, o, lse, n, sq, sk, causal, scale,
                           bi, sg, dr, st);
  if (dtype == kBFloat16) {
    if (sg.q != nullptr && (q_rng == nullptr || kv_rng == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    return tc::launch_d(d, w, q, k, v, o, lse, n, sq, sk, causal, scale, bi,
                        sg, static_cast<const int*>(q_rng),
                        static_cast<const int*>(kv_rng), dr, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
