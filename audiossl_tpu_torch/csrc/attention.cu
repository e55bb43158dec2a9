// Pooled attention with a decomposed relative-position bias on Hopper:
// forward, and the backward in two kernels (dq + dbias, then dk + dv).
//
// Replaces the TPU kernels of audiossl_tpu/ops/attention.py:146
// fused_rel_attention: the forward _fwd_kernel (:88) and the backward
// _bwd_kernel (:95), per (batch * head):
//
//   s   = qs k^T + bias E          qs = q * scale, rounded to the stream dtype
//   p   = softmax(s)               f32, exact over the whole key row
//   out = round(p) v               f32 accumulation, out in v's dtype
//
// E is the 0/1 expansion of rel_expand_matrix(kh, kw), the only E the MViT
// call site passes (models/mvit.py:320), so the kernels read the bias
// decomposed: s[q, j] += bias[q, j / kw] + bias[q, kh + j % kw]. With kh = kw
// = 0 there is no bias (the no-bias mode, plain ViT/AST attention).
//
// Backward, as _bwd_kernel (:105-119) computes it, recomputing p (the score
// matrix is never stored, as on the TPU):
//   dp = dO v^T,   ds = p (dp - rowsum(dp p)),   dq = round(round(ds) k) * scale,
//   dbias = ds E^T (f32),   dk = round(ds)^T qs,   dv = round(p)^T dO.
// It runs as two launches: a dq kernel per (b*h, q-tile), which writes dq,
// dbias and each row's softmax max, sum and rowsum(dp p), and a dk/dv kernel
// per (b*h, key tile), which loops over the q-tiles in order and rebuilds p
// and ds from those row statistics. On the TPU dk and dv accumulate across
// q-tiles in an output block revisited in grid order; here the loop inside
// the block takes that place: no float atomics, and two runs give the same
// bits.
//
// Rounding to the stream dtype happens where the JAX kernel rounds: p before
// p v, ds and p before the dk/dv/dq products, dq before its scale; every sum
// is f32.
//
// Two designs.
//
// f32 (the parity path): every product is f32 FFMA on f32 values, the
// counterpart of the JAX package's HIGHEST path; no TF32. One block of 256
// threads (8 warps). The forward (attn_fwd_kernel) stages k transposed
// ([D][keys | 1], odd stride: conflict-free both along keys and along D), its
// q-tile transposed and the tile's bias rows in shared memory; a thread
// computes the scores of one key for 8 query rows (float4 loads of the q
// tile), a warp takes the softmax of a row, the buffer of k is reused for v,
// and a warp computes 4 (or fewer) output rows, lanes over D. The q-tile is
// 32, 16 or 8 rows (dq: 16 or 8). Where every key fits beside the score
// tile, k and v stay resident (one chunk); where they do not (AST-base: 1214
// keys), they pass through the buffer 64 keys at a time while the score tile
// [rows][Lk | 1] stays whole, so the softmax still sees whole rows and the
// sums keep their order: the same bits either way. The dq kernel does the same with a dp
// tile beside the scores. Both take the bias mode too; their limit is the
// score tiles (at D <= 128 and 8 rows: over 6,000 keys forward, 3,000 dq). The
// dk/dv kernel takes 32 keys a block, one a lane, and streams the queries,
// so its fit does not depend on Lk. D <= 128. In bf16 the forward keeps this
// kernel only where no tensor-core forward takes the shape (D % 8 != 0, or a
// bias with keys that do not fit its shared memory); the bf16 backward takes
// D % 8 == 0 only (every MViT and ViT head width) and raises for a bias whose
// keys its shared memory does not hold.
//
// bf16 (the SS-MAST path): mma.sync.m16n8k16 bf16 x bf16 -> f32 on the
// tensor cores, operands from shared memory through ldmatrix (.trans where
// the product reads a matrix along its rows), staged with cp.async; D is
// zero-padded to 32, 64, 96 or 128, keys to 16 (a padded key scores -inf, so
// p = 0 and ds = 0), queries are masked. In bf16 the JAX kernel computes p
// in f32 over the whole row, rounds p and ds to bf16 and accumulates in f32
// (default MXU precision), which is what the tensor cores compute; only the
// order of the sums changes.
//   attn_fwd_mma: one block of 4 warps (keys <= 128) or 8 per (b*h, 16 query
//     rows a warp), whose qs fragments stay in registers; k and v stay in
//     shared memory (v's copy lands while pass A runs). Two passes over the
//     keys, 16 at a time: the row max and sum, online, then p = exp(s - m) *
//     (1 / l) rounded to bf16 (normalised before the rounding, as in JAX: a
//     flash-style exp(s - m_running) rescaled after the product would round
//     other values) and out += round(p) v with p's C fragments re-used as the
//     A operand. Out goes through shared memory in 16-byte stores. At Lk =
//     306 (D = 96) k, v, the q tile and the bias tile take 186 KB: one block
//     of 8 warps an SM; at Lk = 78, 53 KB: four blocks of 4 warps.
//   attn_bwd_dq_mma: the same block shape, with q and dO fragments in
//     registers. Two passes over the keys, 16 at a time: the row max, the
//     row sum and rowsum(dp p), online (both sums rescaled as the max grows),
//     then ds -> dbias (each lane owns the height or the width sums of one
//     row: deterministic) and dq += round(ds) k with ds's C fragments re-used
//     as the A operand. Its pass A is the forward's pass A with dp beside it.
//   attn_fwd_mma_stream, attn_bwd_dq_mma_stream: the no-bias mode (AST) at
//     every key length. The same passes, but k (and v) come through shared
//     memory 64 keys a stage, double-buffered with cp.async, while the qs
//     (and dO) fragments stay in registers; shared memory does not grow
//     with Lk. The resident kernels above take the bias mode only, and keep
//     their limit.
//   attn_bwd_dkv_mma: one block of 4-8 warps per (b*h, 16 keys a warp,
//     query split); dk and dv stay in registers across the loop over 32-row
//     query tiles, whose q and dO are double-buffered with cp.async and whose
//     bias and statistics are prefetched through registers. s^T = k qs^T and
//     dp^T = v dO^T on the tensor cores; p^T's and ds^T's C fragments are the
//     A operands of dv += p^T dO and dk += ds^T qs. Where (b*h) x key tiles
//     would not fill the card twice over (MAST-B's first stage: 128 blocks),
//     the query tiles split across blocks, each split writes f32 partials
//     and attn_dkv_reduce adds them in split order.
//
// Bound on an H100 SXM: at MAST-B's shapes (B = 64, two views in one pass,
// D = 96) the forward moves, e.g. at (BH, Lq, Lk) = (128, 1212, 78), 72.4 MB
// of q, k, v, bias and out in bf16 (21.6 us at 3.35 TB/s) for 4.6 GFLOP of
// products (4.7 us at 989 TFLOP/s bf16): bound by bytes (chip_smoke.py's
// attention_bound computes it for every shape). Over one SS-MAST step (48
// forward launches) the forward moves 1.92 GB, 0.572 ms, for 94.3 GFLOP of
// products, 0.095 ms at the bf16 rate (1.41 ms on the f32 FFMA pipe): bound
// by bytes. The backward kernels' bytes bound is 0.3864 ms (dq) and 0.4083 ms
// (dk/dv) a step, their products 70.7 and 94.3 GFLOP, 0.072 and 0.095 ms at
// the bf16 rate: bound by bytes. The tensor-core kernels recompute the
// scores once (the forward and dq) and reread k and v from L2 for every
// block of query rows, which is where they spend their time beyond the bound.
// At AST-base's shape, (BH, L, D) = (384, 1214, 64) with no bias, the
// products bound all three: the forward's 144.9 GFLOP take 0.1465 ms at the
// bf16 rate against 0.0713 ms for its 238.7 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kTK = 32;   // keys per block of the dk/dv kernel (one per lane)
constexpr int kTQ2 = 32;  // query rows per step of the dk/dv kernel's loop
constexpr int kSmemLimit = 232448;  // 227 KB per block on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__host__ __device__ inline int align16(long long bytes) { return static_cast<int>((bytes + 15) & ~15LL); }
__host__ __device__ inline int odd(int n) { return n | 1; }

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// out[r][j] = sum_c at[c][r] * bt[c][j] (+ bias[r][(j0 + j) / kw] + bias[r][kh + (j0 + j) % kw]),
// for r < TQ and j < nj; at is [d][TQ] f32, bt [d][ldb]. Every kernel computes
// a score with this one sequence of FMAs, so the scores agree bit for bit.
template <int RPI, int TQ, typename TB>
__device__ void score_tile(const float* at, const TB* bt, int ldb, int nj, int j0, int d,
                           const float* bs, int kb, int kh, int kw, float* out, int ldo) {
    constexpr int groups = TQ / RPI;
    for (int item = threadIdx.x; item < nj * groups; item += kThreads) {
        const int j = item % nj;
        const int r0 = (item / nj) * RPI;
        float acc[RPI];
#pragma unroll
        for (int r = 0; r < RPI; ++r) acc[r] = 0.0f;
        for (int c = 0; c < d; ++c) {
            const float b = to_f(bt[c * ldb + j]);
            const float4* ap = reinterpret_cast<const float4*>(at + c * TQ + r0);
#pragma unroll
            for (int p = 0; p < RPI / 4; ++p) {
                const float4 a = ap[p];
                acc[4 * p] = fmaf(a.x, b, acc[4 * p]);
                acc[4 * p + 1] = fmaf(a.y, b, acc[4 * p + 1]);
                acc[4 * p + 2] = fmaf(a.z, b, acc[4 * p + 2]);
                acc[4 * p + 3] = fmaf(a.w, b, acc[4 * p + 3]);
            }
        }
        const int jg = j0 + j;
#pragma unroll
        for (int r = 0; r < RPI; ++r) {
            float v = acc[r];
            if (bs != nullptr) v += bs[(r0 + r) * kb + jg / kw] + bs[(r0 + r) * kb + kh + jg % kw];
            out[(r0 + r) * ldo + j] = v;
        }
    }
}

// Softmax of each of the TQ rows of s [TQ][ld] over its first n entries, in
// place, a warp per row; with ROUND the probabilities are rounded to T. The
// row's max and sum go to stats[r] and stats[TQ + r] when stats is given.
template <typename T, int TQ, bool ROUND>
__device__ void softmax_rows(float* s, int ld, int n, float* stats) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < TQ; r += kWarps) {
        float* row = s + r * ld;
        float m = __int_as_float(0xff800000);  // -inf
        for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
        m = warp_max(m);
        float l = 0.0f;
        for (int j = lane; j < n; j += 32) l += expf(row[j] - m);
        l = warp_sum(l);
        for (int j = lane; j < n; j += 32) {
            const float p = expf(row[j] - m) / l;
            row[j] = ROUND ? round_to<T>(p) : p;
        }
        if (stats != nullptr && lane == 0) {
            stats[r] = m;
            stats[TQ + r] = l;
        }
    }
}

// acc[i][u] += sum_j p[r][j] * b[j][c] for the rows r = warp + 8 i and the
// columns c = lane + 32 u; b is [nj][d] natural; with ROUND p is rounded to T
// first.
template <typename T, int TQ, bool ROUND, typename TB>
__device__ void rows_times(const float* p, int ldp, const TB* b, int nj, int d, float (&acc)[TQ / kWarps][4]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int j = 0; j < nj; ++j) {
        float bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int c = lane + 32 * u;
            bv[u] = c < d ? to_f(b[j * d + c]) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < TQ / kWarps; ++i) {
            float pv = p[(warp + kWarps * i) * ldp + j];
            if (ROUND) pv = round_to<T>(pv);
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[i][u] = fmaf(pv, bv[u], acc[i][u]);
        }
    }
}

// dst[c * ld + j] = src[j * d + c] for j < n (a [n][d] matrix transposed).
template <typename T, typename TD>
__device__ void load_transposed(const T* __restrict__ src, int n, int d, TD* dst, int ld) {
    for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
        const int j = idx / d, c = idx - j * d;
        dst[c * ld + j] = from_f<TD>(to_f(src[idx]));  // exact: f32 holds every bf16
    }
}

// The rows q0 .. q0 + TQ - 1 of a [lq][w] matrix into dst, as f32: transposed
// [w][TQ] or natural [TQ][w]; rows past lq are zeros.
template <typename T, int TQ, bool TRANSPOSE>
__device__ void load_rows(const T* __restrict__ src, int lq, int q0, int w, float* dst) {
    for (int idx = threadIdx.x; idx < TQ * w; idx += kThreads) {
        const int r = idx / w, c = idx - r * w;
        const int row = q0 + r;
        const float v = row < lq ? to_f(src[static_cast<long long>(row) * w + c]) : 0.0f;
        dst[TRANSPOSE ? c * TQ + r : idx] = v;
    }
}

// Shared memory of the FFMA forward and dq kernels with `ck` keys a chunk:
// the chunk buffer (k transposed [d][ck | 1], or v or k natural), the q (or
// dO) tile, the whole score tile (and dq's dp tile) [TQ][lk | 1], the bias
// tile and dq's row statistics.
template <typename T>
__host__ __device__ inline int fwd_smem(int tq, int lk, int ck, int d, int kb) {
    return align16(static_cast<long long>(sizeof(T)) * d * odd(ck)) + 4 * d * tq + 4 * tq * odd(lk) + align16(4LL * tq * kb);
}

template <typename T>
__host__ __device__ inline int dq_smem(int tq, int lk, int ck, int d, int kb) {
    return align16(static_cast<long long>(sizeof(T)) * d * odd(ck)) + 4 * d * tq + 8 * tq * odd(lk) + align16(4LL * tq * kb) +
           8 * tq;
}

template <typename T>
__host__ __device__ inline int dkv_smem(int d, int kb) {
    return 4 * (2 * d * kTK + 2 * d * kTQ2 + 2 * kTQ2 * kTK) + align16(4LL * kTQ2 * kb) + 12 * kTQ2;
}

// The FFMA forward. Keys pass through shared memory `ck` at a time (ck = lk
// where they all fit: k and v resident, as the forward was first built);
// the score tile stays whole, so the softmax sees whole rows. Chunks are
// taken in key order and every sum keeps its order, so the result does not
// depend on ck.
template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ qs, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ bias, int lq, int lk, int d, int kh, int kw, int tiles, int ck,
                T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int kb = kh + kw;
    const int ldk = odd(lk), ldc = odd(ck);
    T* kv = reinterpret_cast<T*>(smem);  // the chunk: k^T [d][ldc], then v [ck][d]
    float* qt = reinterpret_cast<float*>(smem + align16(static_cast<long long>(sizeof(T)) * d * ldc));
    float* s = qt + d * TQ;
    float* bs = s + TQ * ldk;
    const int bh = blockIdx.x / tiles;
    const int q0 = (blockIdx.x % tiles) * TQ;
    const long long kbase = static_cast<long long>(bh) * lk * d;
    const long long qbase = static_cast<long long>(bh) * lq * d;

    load_rows<T, TQ, true>(qs + qbase, lq, q0, d, qt);
    if (bias != nullptr) load_rows<T, TQ, false>(bias + static_cast<long long>(bh) * lq * kb, lq, q0, kb, bs);
    for (int j0 = 0; j0 < lk; j0 += ck) {
        const int nj = min(ck, lk - j0);
        __syncthreads();  // the previous chunk is done with
        load_transposed(k + kbase + static_cast<long long>(j0) * d, nj, d, kv, ldc);
        __syncthreads();
        score_tile<8, TQ>(qt, kv, ldc, nj, j0, d, bias != nullptr ? bs : nullptr, kb, kh, kw, s + j0, ldk);
    }
    __syncthreads();
    softmax_rows<T, TQ, true>(s, ldk, lk, nullptr);
    float acc[TQ / kWarps][4] = {};
    for (int j0 = 0; j0 < lk; j0 += ck) {
        const int nj = min(ck, lk - j0);
        __syncthreads();
        for (int idx = threadIdx.x; idx < nj * d; idx += kThreads) kv[idx] = v[kbase + static_cast<long long>(j0) * d + idx];
        __syncthreads();
        rows_times<T, TQ, false>(s + j0, ldk, kv, nj, d, acc);
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < TQ / kWarps; ++i) {
        const int row = q0 + warp + kWarps * i;
        if (row >= lq) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int c = lane + 32 * u;
            if (c < d) out[qbase + static_cast<long long>(row) * d + c] = from_f<T>(acc[i][u]);
        }
    }
}

// The FFMA dq kernel, keys `ck` at a time as the forward: k^T chunks -> the
// scores, the softmax over whole rows, v^T chunks -> dp, ds in place of dp,
// dbias, then k chunks -> dq.
template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ qs, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ bias, const T* __restrict__ dout, int lq, int lk, int d, int kh, int kw,
                   int tiles, int ck, float scale, T* __restrict__ dq, T* __restrict__ dbias, float* __restrict__ stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int kb = kh + kw;
    const int ldk = odd(lk), ldc = odd(ck);
    T* kv = reinterpret_cast<T*>(smem);
    float* qt = reinterpret_cast<float*>(smem + align16(static_cast<long long>(sizeof(T)) * d * ldc));
    float* s = qt + d * TQ;
    float* g = s + TQ * ldk;
    float* bs = g + TQ * ldk;
    float* st = bs + align16(4LL * TQ * kb) / 4;  // [2][TQ]: row max, row sum
    const int bh = blockIdx.x / tiles;
    const int q0 = (blockIdx.x % tiles) * TQ;
    const long long kbase = static_cast<long long>(bh) * lk * d;
    const long long qbase = static_cast<long long>(bh) * lq * d;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    load_rows<T, TQ, true>(qs + qbase, lq, q0, d, qt);
    if (bias != nullptr) load_rows<T, TQ, false>(bias + static_cast<long long>(bh) * lq * kb, lq, q0, kb, bs);
    for (int j0 = 0; j0 < lk; j0 += ck) {
        const int nj = min(ck, lk - j0);
        __syncthreads();
        load_transposed(k + kbase + static_cast<long long>(j0) * d, nj, d, kv, ldc);
        __syncthreads();
        score_tile<8, TQ>(qt, kv, ldc, nj, j0, d, bias != nullptr ? bs : nullptr, kb, kh, kw, s + j0, ldk);
    }
    __syncthreads();
    softmax_rows<T, TQ, false>(s, ldk, lk, st);  // p, f32
    __syncthreads();
    load_rows<T, TQ, true>(dout + qbase, lq, q0, d, qt);
    for (int j0 = 0; j0 < lk; j0 += ck) {
        const int nj = min(ck, lk - j0);
        __syncthreads();
        load_transposed(v + kbase + static_cast<long long>(j0) * d, nj, d, kv, ldc);
        __syncthreads();
        score_tile<8, TQ>(qt, kv, ldc, nj, j0, d, static_cast<const float*>(nullptr), 0, 0, 1, g + j0, ldk);  // dp
    }
    __syncthreads();
    for (int r = warp; r < TQ; r += kWarps) {  // ds = p (dp - rowsum(dp p)), in place of dp
        const float* p = s + r * ldk;
        float* row = g + r * ldk;
        float delta = 0.0f;
        for (int j = lane; j < lk; j += 32) delta = fmaf(row[j], p[j], delta);
        delta = warp_sum(delta);
        for (int j = lane; j < lk; j += 32) row[j] = p[j] * (row[j] - delta);
        const int q = q0 + r;
        if (lane == 0 && q < lq) {
            float* out = stats + (static_cast<long long>(bh) * lq + q) * 3;
            out[0] = st[r];
            out[1] = st[TQ + r];
            out[2] = delta;
        }
    }
    __syncthreads();
    if (bias != nullptr) {  // dbias = ds E^T: sums of ds over key-grid rows, then over columns
        for (int idx = threadIdx.x; idx < TQ * kb; idx += kThreads) {
            const int r = idx / kb, e = idx - r * kb;
            const int q = q0 + r;
            if (q >= lq) continue;
            const float* row = g + r * ldk;
            float sum = 0.0f;
            if (e < kh) {
                for (int c = 0; c < kw; ++c) sum += row[e * kw + c];
            } else {
                for (int rr = 0; rr < kh; ++rr) sum += row[rr * kw + (e - kh)];
            }
            dbias[(static_cast<long long>(bh) * lq + q) * kb + e] = from_f<T>(sum);
        }
    }
    float acc[TQ / kWarps][4] = {};
    for (int j0 = 0; j0 < lk; j0 += ck) {
        const int nj = min(ck, lk - j0);
        __syncthreads();
        for (int idx = threadIdx.x; idx < nj * d; idx += kThreads) kv[idx] = k[kbase + static_cast<long long>(j0) * d + idx];
        __syncthreads();
        rows_times<T, TQ, true>(g + j0, ldk, kv, nj, d, acc);
    }
#pragma unroll
    for (int i = 0; i < TQ / kWarps; ++i) {
        const int row = q0 + warp + kWarps * i;
        if (row >= lq) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int c = lane + 32 * u;
            if (c < d) dq[qbase + static_cast<long long>(row) * d + c] = from_f<T>(round_to<T>(acc[i][u]) * scale);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const T* __restrict__ qs, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ bias, const T* __restrict__ dout, const float* __restrict__ stats,
                    int lq, int lk, int d, int kh, int kw, int ktiles, T* __restrict__ dk, T* __restrict__ dv) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int TQ = kTQ2;
    const int kb = kh + kw;
    float* kt = reinterpret_cast<float*>(smem);  // [d][kTK]
    float* vt = kt + d * kTK;                     // [d][kTK]
    float* qt = vt + d * kTK;                     // [d][TQ]
    float* dt = qt + d * TQ;                      // [d][TQ]
    float* p = dt + d * TQ;                       // [TQ][kTK]
    float* g = p + TQ * kTK;                      // [TQ][kTK]
    float* bs = g + TQ * kTK;                     // [TQ][kb]
    float* st = bs + align16(4LL * TQ * kb) / 4;  // [TQ][3]: max, sum, rowsum(dp p)
    const int bh = blockIdx.x / ktiles;
    const int j0 = (blockIdx.x % ktiles) * kTK;
    const int nj = min(kTK, lk - j0);
    const long long kbase = static_cast<long long>(bh) * lk * d;
    const long long qbase = static_cast<long long>(bh) * lq * d;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    for (int idx = threadIdx.x; idx < kTK * d; idx += kThreads) {
        const int j = idx / d, c = idx - j * d;
        const bool in = j < nj;
        kt[c * kTK + j] = in ? to_f(k[kbase + static_cast<long long>(j0 + j) * d + c]) : 0.0f;
        vt[c * kTK + j] = in ? to_f(v[kbase + static_cast<long long>(j0 + j) * d + c]) : 0.0f;
    }
    float dk_acc[kMaxD / kWarps], dv_acc[kMaxD / kWarps];  // columns c = warp + 8 u, key j0 + lane
#pragma unroll
    for (int u = 0; u < kMaxD / kWarps; ++u) dk_acc[u] = dv_acc[u] = 0.0f;

    for (int q0 = 0; q0 < lq; q0 += TQ) {
        __syncthreads();
        load_rows<T, TQ, true>(qs + qbase, lq, q0, d, qt);
        load_rows<T, TQ, true>(dout + qbase, lq, q0, d, dt);
        if (bias != nullptr) load_rows<T, TQ, false>(bias + static_cast<long long>(bh) * lq * kb, lq, q0, kb, bs);
        for (int idx = threadIdx.x; idx < 3 * TQ; idx += kThreads) {
            const int q = q0 + idx / 3;
            st[idx] = q < lq ? stats[(static_cast<long long>(bh) * lq + q0) * 3 + idx] : 0.0f;
        }
        __syncthreads();
        score_tile<4, TQ>(qt, kt, kTK, nj, j0, d, bias != nullptr ? bs : nullptr, kb, kh, kw, p, kTK);
        score_tile<4, TQ>(dt, vt, kTK, nj, j0, d, static_cast<const float*>(nullptr), 0, 0, 1, g, kTK);
        __syncthreads();
        for (int idx = threadIdx.x; idx < TQ * kTK; idx += kThreads) {
            const int r = idx / kTK, j = idx - r * kTK;
            if (q0 + r < lq && j < nj) {
                const float pr = expf(p[idx] - st[3 * r]) / st[3 * r + 1];
                const float ds = pr * (g[idx] - st[3 * r + 2]);
                p[idx] = round_to<T>(pr);
                g[idx] = round_to<T>(ds);
            } else {
                p[idx] = g[idx] = 0.0f;
            }
        }
        __syncthreads();
        for (int r = 0; r < TQ; ++r) {
            const float pj = p[r * kTK + lane];
            const float gj = g[r * kTK + lane];
#pragma unroll
            for (int u = 0; u < kMaxD / kWarps; ++u) {
                const int c = warp + kWarps * u;
                if (c < d) {
                    dk_acc[u] = fmaf(gj, qt[c * TQ + r], dk_acc[u]);
                    dv_acc[u] = fmaf(pj, dt[c * TQ + r], dv_acc[u]);
                }
            }
        }
    }
    if (lane < nj) {
        const long long base = kbase + static_cast<long long>(j0 + lane) * d;
#pragma unroll
        for (int u = 0; u < kMaxD / kWarps; ++u) {
            const int c = warp + kWarps * u;
            if (c < d) {
                dk[base + c] = from_f<T>(dk_acc[u]);
                dv[base + c] = from_f<T>(dv_acc[u]);
            }
        }
    }
}

// ---------------------------------------------------------------- bf16 on tensor cores
//
// Fragments of mma.sync.m16n8k16 (PTX ISA), lane = 4 g + t: A (16 x 16,
// row-major) a0 = (row g, cols 2t, 2t+1), a1 = (g + 8, same), a2 = (g, 2t + 8,
// 2t + 9), a3 = (g + 8, same); B (16 x 8) b0 = (rows 2t, 2t+1, col g), b1 = (rows
// 2t + 8, 2t + 9, col g); C (16 x 8, f32) c0, c1 = (row g, cols 2t, 2t+1), c2, c3
// = (row g + 8, same). Every operand tile lives in shared memory as bf16 rows
// of stride kPad more than the padded head width, so the eight 16-byte rows
// of an ldmatrix land in eight different bank groups.

constexpr int kPad = 8;        // bf16 elements of padding per shared-memory row
constexpr int kDqKeysSmall = 128;  // forward and dq: 4 warps x 16 query rows per block up to these keys, else 8
constexpr int kDkvQ = 32;      // dk/dv kernel: query rows per step of its loop
constexpr int kPrefetch = 8;   // dk/dv kernel: bias / statistics values a thread prefetches per step

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a b, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
                 "{%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zero-filled where `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// bf16 pair (lo, hi) as one register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}

// A operand (16 x 16, k over two adjacent n-tiles) from two C fragments,
// each value rounded to bf16
__device__ __forceinline__ void a_from_c(unsigned (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
    a[0] = pack_bf16(c0[0], c0[1]);
    a[1] = pack_bf16(c0[2], c0[3]);
    a[2] = pack_bf16(c1[0], c1[1]);
    a[3] = pack_bf16(c1[2], c1[3]);
}

// ldmatrix lane addresses (lane = threadIdx.x % 32) into a [rows][ld] bf16 tile:
// A operand rows r0.., cols c0..
__device__ __forceinline__ const __nv_bfloat16* a_addr(const __nv_bfloat16* t, int ld, int r0, int c0, int lane) {
    return t + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
// B operands of two n-tiles (n0.., n0 + 8..) with B[k][n] = t[n][k]: ldsm_x4
__device__ __forceinline__ const __nv_bfloat16* bt_addr(const __nv_bfloat16* t, int ld, int n0, int k0, int lane) {
    return t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8;
}
// B operands of two n-tiles with B[k][n] = t[k][n]: ldsm_x4_t
__device__ __forceinline__ const __nv_bfloat16* bn_addr(const __nv_bfloat16* t, int ld, int k0, int n0, int lane) {
    return t + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 + ((lane >> 4) << 3);
}

// rows [r0, r0 + n) of a [rows][d] bf16 matrix into a [n][ld] tile with
// cp.async (d % 8 == 0), zeros past `rows` and past column d up to dp
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, int rows, int r0,
                                           int n, int d, int dp) {
    const int chunks = dp / 8;
    for (int idx = threadIdx.x; idx < n * chunks; idx += blockDim.x) {
        const int r = idx / chunks, c = (idx - r * chunks) * 8;
        const bool valid = r0 + r < rows && c < d;
        cp_async16(dst + r * ld + c, valid ? src + static_cast<long long>(r0 + r) * d + c : src, valid);
    }
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Warps (16 query rows each) per block of the forward and the dq kernel: 4
// for short keys, where k and v are small and more blocks fit on an SM; 8 for
// long keys, where one block fills the shared memory and should keep 8 warps
// busy.
__host__ __device__ inline int mma_row_warps(int lk) { return lk <= kDqKeysSmall ? 4 : 8; }

// The bias tile of `rows` query rows from q0 of head bh as f32 [rows][kb]
// (zeros past lq), 8 loads in flight a thread, and each key's two bias
// columns kidx[j] = (j / kw) | ((kh + j % kw) << 16) for j < lkp (0 past lk).
__device__ __forceinline__ void stage_bias(float* bs, int* kidx, const __nv_bfloat16* __restrict__ bias, int bh, int lq,
                                           int q0, int rows, int lk, int lkp, int kh, int kw) {
    const int kb = kh + kw;
    if (kb == 0) return;
    const __nv_bfloat16* b = bias + (static_cast<long long>(bh) * lq + q0) * kb;
    const int nb = rows * kb, nvalid = (lq - q0 < rows ? lq - q0 : rows) * kb;
    for (int base = threadIdx.x; base < nb; base += 8 * blockDim.x) {
        float r[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int idx = base + i * blockDim.x;
            r[i] = idx < nvalid ? __bfloat162float(b[idx]) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
            if (base + i * blockDim.x < nb) bs[base + i * blockDim.x] = r[i];
    }
    for (int j = threadIdx.x; j < lkp; j += blockDim.x) kidx[j] = j < lk ? (j / kw) | ((kh + j % kw) << 16) : 0;
}

// The scores of the 16 keys kc .. kc + 15 for a warp's rows g and g + 8 (C
// fragments of two n-tiles): qs k^T from the warp's q fragments and k in
// shared memory ([lkp][ld]), plus the decomposed bias from the rows brow[0]
// and brow[1] of the bias tile; keys past lk score -inf.
template <int KD>
__device__ __forceinline__ void score_chunk(float (&s)[2][4], const unsigned (&qf)[KD][4], const __nv_bfloat16* ks, int ld,
                                            int kc, int lk, int kb, const int* kidx, const float* const (&brow)[2],
                                            int lane) {
    const int t = lane & 3;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int st = 0; st < KD; ++st) {
        unsigned b[4];
        ldsm_x4(b, bt_addr(ks, ld, kc, st * 16, lane));
        mma_bf16(s[0], qf[st], b[0], b[1]);
        mma_bf16(s[1], qf[st], b[2], b[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = kc + 8 * n + 2 * t + (e & 1);
            if (j >= lk) {
                s[n][e] = __int_as_float(0xff800000);
            } else if (kb > 0) {
                const int ix = kidx[j];
                const float* br = brow[e >> 1];
                s[n][e] += br[ix & 0xffff] + br[ix >> 16];
            }
        }
}

// dp = dO v^T for the 16 keys kc .. kc + 15 (C fragments of two n-tiles),
// from the warp's dO fragments and v in shared memory ([keys][ld]).
template <int KD>
__device__ __forceinline__ void dp_chunk(float (&p)[2][4], const unsigned (&of)[KD][4], const __nv_bfloat16* vs, int ld,
                                         int kc, int lane) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[n][e] = 0.0f;
#pragma unroll
    for (int st = 0; st < KD; ++st) {
        unsigned b[4];
        ldsm_x4(b, bt_addr(vs, ld, kc, st * 16, lane));
        mma_bf16(p[0], of[st], b[0], b[1]);
        mma_bf16(p[1], of[st], b[2], b[3]);
    }
}

// Shared memory of the dq kernel at head width dp = 16 KD: k and v [lkp][dp +
// kPad], then one region that first holds the q and dO tiles [16 warps][dp +
// kPad] and then, per warp, ds of a 16-key chunk [16][17] f32 and the dbias
// sums [16][kb] f32; the bias tile [16 warps][kb] f32; each key's two bias columns.
__host__ __device__ inline int dq_mma_smem(int lk, int dp, int kb) {
    const int warps = mma_row_warps(lk);
    const int lkp = round_up(lk, 16), ld = dp + kPad, rows = 16 * warps;
    const int tiles = 2 * 2 * rows * ld;
    const int scratch = 4 * warps * 16 * (17 + kb);
    return 2 * 2 * lkp * ld + round_up(tiles > scratch ? tiles : scratch, 16) + round_up(4 * rows * kb, 16) + 4 * lkp;
}

// Shared memory of the dk/dv kernel with `warps` x 16 keys: k and v tiles,
// two buffers each of q and dO [kDkvQ][dp + kPad], bias [kDkvQ][kb] f32 and
// statistics [kDkvQ][3] f32.
__host__ __device__ inline int dkv_mma_smem(int warps, int dp, int kb) {
    const int ld = dp + kPad;
    return 2 * 2 * 16 * warps * ld + 2 * 2 * 2 * kDkvQ * ld + 2 * 4 * kDkvQ * (kb + 3);
}

// Shared memory of the forward at head width dp = 16 KD: k and v [lkp][dp +
// kPad], the q tile [16 warps][dp + kPad] (each warp's rows then stage its
// output), the bias tile [16 warps][kb] f32 and each key's two bias columns.
__host__ __device__ inline int fwd_mma_smem(int lk, int dp, int kb) {
    const int lkp = round_up(lk, 16), ld = dp + kPad, rows = 16 * mma_row_warps(lk);
    return 2 * 2 * lkp * ld + 2 * rows * ld + round_up(4 * rows * kb, 16) + 4 * lkp;
}

// The forward, bf16 operands on the tensor cores. One block of WARPS warps
// per (b*h, 16 WARPS query rows), a warp per 16 rows whose qs fragments stay
// in registers; k and v stay in shared memory for the whole block (v's copy
// lands while pass A runs). Each warp makes two passes over the keys in
// chunks of 16: (A) the scores (bias added into the C fragments) -> the row
// max and the row sum, online (the sum rescaled when the max grows); (B) the
// scores again -> p = exp(s - m) (1 / l), normalised before it is rounded to
// bf16 as the JAX kernel rounds it, and out += round(p) v with p's C
// fragments re-used as the A operand and v read through ldmatrix.trans. The
// output goes out through shared memory in 16-byte stores.
template <int KD, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
attn_fwd_mma(const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ bias, int lq, int lk, int d, int kh,
             int kw, int tiles, __nv_bfloat16* __restrict__ out) {
    constexpr int DP = 16 * KD, LD = DP + kPad, ROWS = 16 * WARPS;
    extern __shared__ __align__(16) unsigned char smem[];
    const int kb = kh + kw, lkp = round_up(lk, 16);
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* vs = ks + lkp * LD;
    __nv_bfloat16* qt = vs + lkp * LD;
    float* bs = reinterpret_cast<float*>(qt + ROWS * LD);
    int* kidx = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(bs) + round_up(4 * ROWS * kb, 16));
    const int bh = blockIdx.x / tiles;
    const int q0 = (blockIdx.x % tiles) * ROWS;
    const long long kbase = static_cast<long long>(bh) * lk * d;
    const long long qbase = static_cast<long long>(bh) * lq * d;

    stage_rows(ks, LD, k + kbase, lk, 0, lkp, d, DP);
    stage_rows(qt, LD, qs + qbase, lq, q0, ROWS, d, DP);
    cp_async_commit();
    stage_rows(vs, LD, v + kbase, lk, 0, lkp, d, DP);
    cp_async_commit();
    stage_bias(bs, kidx, bias, bh, lq, q0, ROWS, lk, lkp, kh, kw);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // k and q are in; v may still be on its way
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + warp * 16;
    const bool active = r0 < lq;
    unsigned qf[KD][4];
#pragma unroll
    for (int s = 0; s < KD; ++s) ldsm_x4(qf[s], a_addr(qt, LD, warp * 16, s * 16, lane));
    const float* const brow[2] = {bs + (warp * 16 + g) * kb, bs + (warp * 16 + g + 8) * kb};

    // (A) row max and row sum, online
    float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)}, l[2] = {0.0f, 0.0f};
    for (int kc = 0; active && kc < lkp; kc += 16) {
        float s[2][4];
        score_chunk<KD>(s, qf, ks, LD, kc, lk, kb, kidx, brow, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float cm = quad_max(fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1])));
            const float mn = fmaxf(m[h], cm);
            float sum = l[h] * expf(m[h] - mn);
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e) sum += expf(s[n][e] - mn);
            m[h] = mn;
            l[h] = sum;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
    cp_async_wait_all();
    __syncthreads();  // v is in
    if (!active) return;

    // (B) out = round(p) v, p = exp(s - m) times 1 / l: one division a row
    // (a division in the loop calls its slow path, whose frame spilled at D = 64)
    const float rl[2] = {1.0f / l[0], 1.0f / l[1]};
    float acc[2 * KD][4];
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    for (int kc = 0; kc < lkp; kc += 16) {
        float s[2][4];
        score_chunk<KD>(s, qf, ks, LD, kc, lk, kb, kidx, brow, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - m[e >> 1]) * rl[e >> 1];
        unsigned a[4];
        a_from_c(a, s[0], s[1]);
#pragma unroll
        for (int dn = 0; dn < KD; ++dn) {
            unsigned b[4];
            ldsm_x4_t(b, bn_addr(vs, LD, kc, dn * 16, lane));
            mma_bf16(acc[2 * dn], a, b[0], b[1]);
            mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
        }
    }

    // out through the warp's own rows of the q tile, 16 bytes a store
    __nv_bfloat16* ot = qt + warp * 16 * LD;
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
        const int c = 8 * n + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(ot + g * LD + c) = __floats2bfloat162_rn(acc[n][0], acc[n][1]);
        *reinterpret_cast<__nv_bfloat162*>(ot + (g + 8) * LD + c) = __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
    __syncwarp();
    const int chunks = d / 8;
    for (int idx = lane; idx < 16 * chunks; idx += 32) {
        const int r = idx / chunks, c = (idx - r * chunks) * 8;
        if (r0 + r < lq)
            *reinterpret_cast<uint4*>(out + qbase + static_cast<long long>(r0 + r) * d + c) =
                *reinterpret_cast<const uint4*>(ot + r * LD + c);
    }
}

// dq, dbias and the row statistics, bf16 operands on the tensor cores. One
// block of WARPS warps per (b*h, 16 WARPS query rows), a warp per 16 rows; k
// and v stay in shared memory for the whole block. Each warp makes two
// passes over the keys in chunks of 16 (one ldmatrix.x4 of k or v per 16
// columns of D): (A) scores and dp -> the row max, the row sum and
// rowsum(dp p), online (both sums rescaled when the max grows); (B) p, dp ->
// ds: dbias from ds (f32), dq += round(ds) k with ds's C fragments re-used as
// the A operand.
template <int KD, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
attn_bwd_dq_mma(const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ bias,
                const __nv_bfloat16* __restrict__ dout, int lq, int lk, int d, int kh, int kw, int tiles, float scale,
                __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dbias, float* __restrict__ stats) {
    constexpr int DP = 16 * KD, LD = DP + kPad, ROWS = 16 * WARPS;
    extern __shared__ __align__(16) unsigned char smem[];
    const int kb = kh + kw, lkp = round_up(lk, 16);
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* vs = ks + lkp * LD;
    unsigned char* region = reinterpret_cast<unsigned char*>(vs + lkp * LD);
    __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(region);
    __nv_bfloat16* ot = qt + ROWS * LD;
    const int tiles_bytes = 2 * 2 * ROWS * LD, scratch_bytes = 4 * WARPS * 16 * (17 + kb);
    float* bs = reinterpret_cast<float*>(region + round_up(tiles_bytes > scratch_bytes ? tiles_bytes : scratch_bytes, 16));
    int* kidx = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(bs) + round_up(4 * ROWS * kb, 16));
    const int bh = blockIdx.x / tiles;
    const int q0 = (blockIdx.x % tiles) * ROWS;
    const long long kbase = static_cast<long long>(bh) * lk * d;
    const long long qbase = static_cast<long long>(bh) * lq * d;

    stage_rows(ks, LD, k + kbase, lk, 0, lkp, d, DP);
    stage_rows(vs, LD, v + kbase, lk, 0, lkp, d, DP);
    stage_rows(qt, LD, qs + qbase, lq, q0, ROWS, d, DP);
    stage_rows(ot, LD, dout + qbase, lq, q0, ROWS, d, DP);
    cp_async_commit();
    stage_bias(bs, kidx, bias, bh, lq, q0, ROWS, lk, lkp, kh, kw);
    cp_async_wait_all();
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    unsigned qf[KD][4], of[KD][4];
#pragma unroll
    for (int s = 0; s < KD; ++s) {
        ldsm_x4(qf[s], a_addr(qt, LD, warp * 16, s * 16, lane));
        ldsm_x4(of[s], a_addr(ot, LD, warp * 16, s * 16, lane));
    }
    __syncthreads();  // the q / dO region becomes the warps' scratch
    const int r0 = q0 + warp * 16;
    if (r0 >= lq) return;
    float* dsc = reinterpret_cast<float*>(region) + warp * 16 * (17 + kb);  // [16][17]
    float* bkt = dsc + 16 * 17;                                              // [16][kb]
    const float* const brow[2] = {bs + (warp * 16 + g) * kb, bs + (warp * 16 + g + 8) * kb};
    auto scores = [&](float (&s)[2][4], int kc) { score_chunk<KD>(s, qf, ks, LD, kc, lk, kb, kidx, brow, lane); };
    auto dps = [&](float (&p)[2][4], int kc) { dp_chunk<KD>(p, of, vs, LD, kc, lane); };

    // (A) row max, row sum and rowsum(dp p), online
    float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)}, l[2] = {0.0f, 0.0f}, u[2] = {0.0f, 0.0f};
    for (int kc = 0; kc < lkp; kc += 16) {
        float s[2][4], dp[2][4];
        scores(s, kc);
        dps(dp, kc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float cm = quad_max(fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1])));
            const float mn = fmaxf(m[h], cm);
            const float r = expf(m[h] - mn);
            float sum = l[h] * r, dot = u[h] * r;
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e) {
                    const float x = expf(s[n][e] - mn);
                    sum += x;
                    dot = fmaf(dp[n][e], x, dot);
                }
            m[h] = mn;
            l[h] = sum;
            u[h] = dot;
        }
    }
    float delta[2], rl[2];  // one division a row, as in the forward
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] = quad_sum(l[h]);
        rl[h] = 1.0f / l[h];
        delta[h] = quad_sum(u[h]) * rl[h];
    }

    // (B) ds -> dbias and dq
    float acc[2 * KD][4];
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    const int own = lane & 15;  // lanes 0-15: row own's height sums; 16-31: its width sums
    const bool width = lane >= 16;
    for (int e = width ? kh : 0; e < (width ? kb : kh); ++e) bkt[own * kb + e] = 0.0f;
    for (int kc = 0; kc < lkp; kc += 16) {
        float s[2][4], ds[2][4];
        scores(s, kc);
        dps(ds, kc);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = expf(s[n][e] - m[e >> 1]) * rl[e >> 1];
                ds[n][e] = p * (ds[n][e] - delta[e >> 1]);
            }
        if (kb > 0) {
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) dsc[(g + 8 * (e >> 1)) * 17 + 8 * n + 2 * t + (e & 1)] = ds[n][e];
            __syncwarp();
            const int jn = min(16, lk - kc);
            int cur = -1;  // a run of keys into one sum adds up in a register first
            float run = 0.0f;
            for (int jl = 0; jl < jn; ++jl) {
                const int ix = kidx[kc + jl];
                const int e = width ? ix >> 16 : ix & 0xffff;
                if (e != cur) {
                    if (cur >= 0) bkt[own * kb + cur] += run;
                    cur = e;
                    run = 0.0f;
                }
                run += dsc[own * 17 + jl];
            }
            if (cur >= 0) bkt[own * kb + cur] += run;
            __syncwarp();
        }
        unsigned a[4];
        a_from_c(a, ds[0], ds[1]);
#pragma unroll
        for (int dn = 0; dn < KD; ++dn) {
            unsigned b[4];
            ldsm_x4_t(b, bn_addr(ks, LD, kc, dn * 16, lane));
            mma_bf16(acc[2 * dn], a, b[0], b[1]);
            mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = r0 + g + 8 * h;
        if (q >= lq) continue;
#pragma unroll
        for (int n = 0; n < 2 * KD; ++n) {
            const int c = 8 * n + 2 * t;
            if (c < d) {
                const float x0 = round_to<__nv_bfloat16>(acc[n][2 * h]) * scale;
                const float x1 = round_to<__nv_bfloat16>(acc[n][2 * h + 1]) * scale;
                *reinterpret_cast<__nv_bfloat162*>(dq + qbase + static_cast<long long>(q) * d + c) =
                    __floats2bfloat162_rn(x0, x1);
            }
        }
        if (t == 0) {
            float* out = stats + (static_cast<long long>(bh) * lq + q) * 3;
            out[0] = m[h];
            out[1] = l[h];
            out[2] = delta[h];
        }
    }
    if (kb > 0 && r0 + own < lq) {
        __nv_bfloat16* out = dbias + (static_cast<long long>(bh) * lq + r0 + own) * kb;
        for (int e = width ? kh : 0; e < (width ? kb : kh); ++e) out[e] = __float2bfloat16(bkt[own * kb + e]);
    }
}

// ---------------------------------------------------------------- streamed over keys (no bias)
//
// The no-bias forward and dq (AST; at AST-base's 1214 keys, D = 64, k and v
// alone would take 175 KB of shared memory) keep the resident kernels' two
// passes and their 16-key arithmetic but take the keys through shared memory
// kChunk at a time, double-buffered with cp.async: one sequence of 2 x
// chunks stages, pass A's then pass B's, the next stage's copy in flight
// while the block computes the current one. Shared memory does not grow with
// Lk, so they take any key length. A padded key scores -inf in every chunk,
// as in the resident kernels; a 16-key step past the chunk's last key is
// skipped. Each key's scores, and every sum, are the resident kernels' in
// the same order. Every bf16 no-bias call comes here; the decomposed bias
// mode keeps the resident kernels (and their shared-memory limit).

constexpr int kChunk = 64;        // keys a stage of the streamed kernels
constexpr int kStreamWarps = 8;   // warps (16 query rows each) a block of the streamed kernels

// Shared memory of the streamed kernels at head width dp: k and v, two
// buffers each [kChunk][dp + kPad], and the q tile (dq: q and dO tiles)
// [16 kStreamWarps][dp + kPad], bf16.
__host__ __device__ inline int fwd_stream_smem(int dp) {
    return 2 * (2 * 2 * kChunk + 16 * kStreamWarps) * (dp + kPad);
}
__host__ __device__ inline int dq_stream_smem(int dp) {
    return 2 * (2 * 2 * kChunk + 2 * 16 * kStreamWarps) * (dp + kPad);
}

// The forward, streamed: attn_fwd_mma's passes over kChunk-key stages.
template <int KD>
__global__ void __launch_bounds__(32 * kStreamWarps)
attn_fwd_mma_stream(const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, int lq, int lk, int d, int tiles,
                    __nv_bfloat16* __restrict__ out) {
    constexpr int DP = 16 * KD, LD = DP + kPad, ROWS = 16 * kStreamWarps, CK = kChunk;
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][CK][LD]
    __nv_bfloat16* vbuf = kbuf + 2 * CK * LD;                       // [2][CK][LD]
    __nv_bfloat16* qt = vbuf + 2 * CK * LD;                         // [ROWS][LD]
    const int bh = blockIdx.x / tiles;
    const int q0 = (blockIdx.x % tiles) * ROWS;
    const long long kbase = static_cast<long long>(bh) * lk * d;
    const long long qbase = static_cast<long long>(bh) * lq * d;
    const int chunks = (lk + CK - 1) / CK, stages = 2 * chunks;
    // stage i < chunks: k of chunk i (pass A); else k and v of chunk i - chunks (pass B); buffer i & 1
    auto stage = [&](int i) {
        const int c = i < chunks ? i : i - chunks;
        stage_rows(kbuf + (i & 1) * CK * LD, LD, k + kbase, lk, c * CK, CK, d, DP);
        if (i >= chunks) stage_rows(vbuf + (i & 1) * CK * LD, LD, v + kbase, lk, c * CK, CK, d, DP);
        cp_async_commit();
    };
    stage_rows(qt, LD, qs + qbase, lq, q0, ROWS, d, DP);
    stage(0);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + warp * 16;
    const bool active = r0 < lq;
    const float* const brow[2] = {nullptr, nullptr};
    unsigned qf[KD][4];
    float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)}, l[2] = {0.0f, 0.0f}, rl[2];
    float acc[2 * KD][4];
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

    for (int i = 0; i < stages; ++i) {
        cp_async_wait_all();
        __syncthreads();  // stage i is in; every warp is done with the buffer stage i + 1 fills
        if (i == 0) {
#pragma unroll
            for (int s = 0; s < KD; ++s) ldsm_x4(qf[s], a_addr(qt, LD, warp * 16, s * 16, lane));
        }
        if (i + 1 < stages) stage(i + 1);
        if (i == chunks) {
#pragma unroll
            for (int h = 0; h < 2; ++h) rl[h] = 1.0f / quad_sum(l[h]);
        }
        if (!active) continue;
        const int c = i < chunks ? i : i - chunks;
        const int valid = min(CK, lk - c * CK);
        const __nv_bfloat16* ks = kbuf + (i & 1) * CK * LD;
        if (i < chunks) {  // (A) row max and row sum, online
            for (int kc = 0; kc < valid; kc += 16) {
                float s[2][4];
                score_chunk<KD>(s, qf, ks, LD, kc, valid, 0, nullptr, brow, lane);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float cm = quad_max(fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1])));
                    const float mn = fmaxf(m[h], cm);
                    float sum = l[h] * expf(m[h] - mn);
#pragma unroll
                    for (int n = 0; n < 2; ++n)
#pragma unroll
                        for (int e = 2 * h; e < 2 * h + 2; ++e) sum += expf(s[n][e] - mn);
                    m[h] = mn;
                    l[h] = sum;
                }
            }
        } else {  // (B) out += round(p) v
            const __nv_bfloat16* vs = vbuf + (i & 1) * CK * LD;
            for (int kc = 0; kc < valid; kc += 16) {
                float s[2][4];
                score_chunk<KD>(s, qf, ks, LD, kc, valid, 0, nullptr, brow, lane);
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - m[e >> 1]) * rl[e >> 1];
                unsigned a[4];
                a_from_c(a, s[0], s[1]);
#pragma unroll
                for (int dn = 0; dn < KD; ++dn) {
                    unsigned b[4];
                    ldsm_x4_t(b, bn_addr(vs, LD, kc, dn * 16, lane));
                    mma_bf16(acc[2 * dn], a, b[0], b[1]);
                    mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
                }
            }
        }
    }
    if (!active) return;

    // out through the warp's own rows of the q tile, 16 bytes a store
    __nv_bfloat16* ot = qt + warp * 16 * LD;
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
        const int c = 8 * n + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(ot + g * LD + c) = __floats2bfloat162_rn(acc[n][0], acc[n][1]);
        *reinterpret_cast<__nv_bfloat162*>(ot + (g + 8) * LD + c) = __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
    __syncwarp();
    const int dchunks = d / 8;
    for (int idx = lane; idx < 16 * dchunks; idx += 32) {
        const int r = idx / dchunks, c = (idx - r * dchunks) * 8;
        if (r0 + r < lq)
            *reinterpret_cast<uint4*>(out + qbase + static_cast<long long>(r0 + r) * d + c) =
                *reinterpret_cast<const uint4*>(ot + r * LD + c);
    }
}

// dq and the row statistics, streamed: attn_bwd_dq_mma's passes (no bias)
// over kChunk-key stages, each stage bringing that chunk's k and v.
template <int KD>
__global__ void __launch_bounds__(32 * kStreamWarps)
attn_bwd_dq_mma_stream(const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout, int lq, int lk,
                       int d, int tiles, float scale, __nv_bfloat16* __restrict__ dq, float* __restrict__ stats) {
    constexpr int DP = 16 * KD, LD = DP + kPad, ROWS = 16 * kStreamWarps, CK = kChunk;
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][CK][LD]
    __nv_bfloat16* vbuf = kbuf + 2 * CK * LD;                       // [2][CK][LD]
    __nv_bfloat16* qt = vbuf + 2 * CK * LD;                         // [ROWS][LD]
    __nv_bfloat16* ot = qt + ROWS * LD;                             // [ROWS][LD]
    const int bh = blockIdx.x / tiles;
    const int q0 = (blockIdx.x % tiles) * ROWS;
    const long long kbase = static_cast<long long>(bh) * lk * d;
    const long long qbase = static_cast<long long>(bh) * lq * d;
    const int chunks = (lk + CK - 1) / CK, stages = 2 * chunks;
    auto stage = [&](int i) {  // k and v of chunk i % chunks into buffer i & 1
        const int c = i < chunks ? i : i - chunks;
        stage_rows(kbuf + (i & 1) * CK * LD, LD, k + kbase, lk, c * CK, CK, d, DP);
        stage_rows(vbuf + (i & 1) * CK * LD, LD, v + kbase, lk, c * CK, CK, d, DP);
        cp_async_commit();
    };
    stage_rows(qt, LD, qs + qbase, lq, q0, ROWS, d, DP);
    stage_rows(ot, LD, dout + qbase, lq, q0, ROWS, d, DP);
    stage(0);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + warp * 16;
    const bool active = r0 < lq;
    const float* const brow[2] = {nullptr, nullptr};
    unsigned qf[KD][4], of[KD][4];
    float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)}, l[2] = {0.0f, 0.0f}, u[2] = {0.0f, 0.0f};
    float delta[2] = {0.0f, 0.0f}, rl[2] = {0.0f, 0.0f};
    float acc[2 * KD][4];
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

    for (int i = 0; i < stages; ++i) {
        cp_async_wait_all();
        __syncthreads();
        if (i == 0) {
#pragma unroll
            for (int s = 0; s < KD; ++s) {
                ldsm_x4(qf[s], a_addr(qt, LD, warp * 16, s * 16, lane));
                ldsm_x4(of[s], a_addr(ot, LD, warp * 16, s * 16, lane));
            }
        }
        if (i + 1 < stages) stage(i + 1);
        if (i == chunks) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                l[h] = quad_sum(l[h]);
                rl[h] = 1.0f / l[h];
                delta[h] = quad_sum(u[h]) * rl[h];
            }
        }
        if (!active) continue;
        const int c = i < chunks ? i : i - chunks;
        const int valid = min(CK, lk - c * CK);
        const __nv_bfloat16* ks = kbuf + (i & 1) * CK * LD;
        const __nv_bfloat16* vs = vbuf + (i & 1) * CK * LD;
        for (int kc = 0; kc < valid; kc += 16) {
            float s[2][4], dp[2][4];
            score_chunk<KD>(s, qf, ks, LD, kc, valid, 0, nullptr, brow, lane);
            dp_chunk<KD>(dp, of, vs, LD, kc, lane);
            if (i < chunks) {  // (A) row max, row sum and rowsum(dp p), online
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float cm = quad_max(fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1])));
                    const float mn = fmaxf(m[h], cm);
                    const float r = expf(m[h] - mn);
                    float sum = l[h] * r, dot = u[h] * r;
#pragma unroll
                    for (int n = 0; n < 2; ++n)
#pragma unroll
                        for (int e = 2 * h; e < 2 * h + 2; ++e) {
                            const float x = expf(s[n][e] - mn);
                            sum += x;
                            dot = fmaf(dp[n][e], x, dot);
                        }
                    m[h] = mn;
                    l[h] = sum;
                    u[h] = dot;
                }
            } else {  // (B) ds, dq += round(ds) k
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = expf(s[n][e] - m[e >> 1]) * rl[e >> 1];
                        dp[n][e] = p * (dp[n][e] - delta[e >> 1]);
                    }
                unsigned a[4];
                a_from_c(a, dp[0], dp[1]);
#pragma unroll
                for (int dn = 0; dn < KD; ++dn) {
                    unsigned b[4];
                    ldsm_x4_t(b, bn_addr(ks, LD, kc, dn * 16, lane));
                    mma_bf16(acc[2 * dn], a, b[0], b[1]);
                    mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
                }
            }
        }
    }
    if (!active) return;

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = r0 + g + 8 * h;
        if (q >= lq) continue;
#pragma unroll
        for (int n = 0; n < 2 * KD; ++n) {
            const int c = 8 * n + 2 * t;
            if (c < d) {
                const float x0 = round_to<__nv_bfloat16>(acc[n][2 * h]) * scale;
                const float x1 = round_to<__nv_bfloat16>(acc[n][2 * h + 1]) * scale;
                *reinterpret_cast<__nv_bfloat162*>(dq + qbase + static_cast<long long>(q) * d + c) =
                    __floats2bfloat162_rn(x0, x1);
            }
        }
        if (t == 0) {
            float* out = stats + (static_cast<long long>(bh) * lq + q) * 3;
            out[0] = m[h];
            out[1] = l[h];
            out[2] = delta[h];
        }
    }
}

// dk and dv, bf16 operands on the tensor cores. One block per (b*h, key tile
// of 16 x warps keys, query split); a warp keeps the dk and dv of its 16 keys
// in registers across the loop over kDkvQ-row query tiles, which computes
// s^T = k qs^T and dp^T = v dO^T and rebuilds p and ds from the row
// statistics; p^T's and ds^T's C fragments are the A operand of dv += p^T dO
// and dk += ds^T qs directly. The next query tile is staged with cp.async (q
// and dO) and through registers (bias and statistics) while the block computes
// the current one. With splits > 1 each split writes f32 partial sums, and
// attn_dkv_reduce adds them in split order (no atomics).
template <int KD>
__global__ void __launch_bounds__(256)
attn_bwd_dkv_mma(const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats, int lq, int lk, int d, int kh,
                 int kw, int ktiles, int splits, int per_split, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, float* __restrict__ partial) {
    constexpr int DP = 16 * KD, LD = DP + kPad, TQ = kDkvQ;
    extern __shared__ __align__(16) unsigned char smem[];
    const int warps = blockDim.x / 32, kt_rows = 16 * warps, kb = kh + kw;
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* vs = ks + kt_rows * LD;
    __nv_bfloat16* qt = vs + kt_rows * LD;   // [2][TQ][LD]
    __nv_bfloat16* ot = qt + 2 * TQ * LD;    // [2][TQ][LD]
    float* bs = reinterpret_cast<float*>(ot + 2 * TQ * LD);  // [2][TQ][kb]
    float* st = bs + 2 * TQ * kb;                            // [2][TQ][3]
    const int sp = blockIdx.x % splits;
    const int kt = (blockIdx.x / splits) % ktiles;
    const int bh = blockIdx.x / (splits * ktiles);
    const int j0 = kt * kt_rows;
    const long long kbase = static_cast<long long>(bh) * lk * d;
    const long long qbase = static_cast<long long>(bh) * lq * d;
    const __nv_bfloat16* brows = kb > 0 ? bias + static_cast<long long>(bh) * lq * kb : bias;
    const float* srows = stats + static_cast<long long>(bh) * lq * 3;
    const int qtiles = (lq + TQ - 1) / TQ;
    const int ta = sp * per_split, tb = min(qtiles, ta + per_split);
    const int nb = TQ * kb, ns = TQ * 3;  // bias and statistics values of one tile

    // the bias and statistics of query tile `tile`: into registers, then shared memory
    auto fetch = [&](float (&r)[kPrefetch], int tile) {
        const int q0 = tile * TQ;
#pragma unroll
        for (int i = 0; i < kPrefetch; ++i) {
            const int idx = threadIdx.x + i * blockDim.x;
            float x = 0.0f;
            if (idx < nb) {
                if (q0 + idx / kb < lq) x = __bfloat162float(brows[static_cast<long long>(q0) * kb + idx]);
            } else if (idx < nb + ns) {
                const int u = idx - nb;
                if (q0 + u / 3 < lq) x = srows[static_cast<long long>(q0) * 3 + u];
                else x = (u % 3 == 1) ? 1.0f : 0.0f;
            }
            r[i] = x;
        }
    };
    auto store = [&](const float (&r)[kPrefetch], int buf) {
#pragma unroll
        for (int i = 0; i < kPrefetch; ++i) {
            const int idx = threadIdx.x + i * blockDim.x;
            if (idx < nb) bs[buf * nb + idx] = r[i];
            else if (idx < nb + ns) st[buf * ns + idx - nb] = r[i];
        }
    };

    stage_rows(ks, LD, k + kbase, lk, j0, kt_rows, d, DP);
    stage_rows(vs, LD, v + kbase, lk, j0, kt_rows, d, DP);
    if (ta < tb) {
        stage_rows(qt, LD, qs + qbase, lq, ta * TQ, TQ, d, DP);
        stage_rows(ot, LD, dout + qbase, lq, ta * TQ, TQ, d, DP);
    }
    cp_async_commit();
    float pre[kPrefetch];
    if (ta < tb) {
        fetch(pre, ta);
        store(pre, 0);
    }

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int jw = j0 + warp * 16;  // the warp's first key
    const bool active = jw < lk;
    int bcol[2][2] = {{0, 0}, {0, 0}};  // the two bias columns of keys jw + g and jw + g + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int j = jw + g + 8 * h;
        if (kb > 0 && j < lk) {
            bcol[h][0] = j / kw;
            bcol[h][1] = kh + j % kw;
        }
    }
    float dka[2 * KD][4], dva[2 * KD][4];
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

    int buf = 0;
    for (int tile = ta; tile < tb; ++tile, buf ^= 1) {
        cp_async_wait_all();
        __syncthreads();
        const bool next = tile + 1 < tb;
        if (next) {
            stage_rows(qt + (buf ^ 1) * TQ * LD, LD, qs + qbase, lq, (tile + 1) * TQ, TQ, d, DP);
            stage_rows(ot + (buf ^ 1) * TQ * LD, LD, dout + qbase, lq, (tile + 1) * TQ, TQ, d, DP);
            cp_async_commit();
            fetch(pre, tile + 1);
        }
        if (active) {
            const __nv_bfloat16* qb = qt + buf * TQ * LD;
            const __nv_bfloat16* ob = ot + buf * TQ * LD;
            const float* bb = bs + buf * nb;
            const float* sb = st + buf * ns;
            const int q0 = tile * TQ;
            float p[TQ / 8][4], ds[TQ / 8][4];
#pragma unroll
            for (int n = 0; n < TQ / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) p[n][e] = ds[n][e] = 0.0f;
#pragma unroll
            for (int s = 0; s < KD; ++s) {  // s^T = k qs^T, dp^T = v dO^T
                unsigned ak[4], av[4];
                ldsm_x4(ak, a_addr(ks, LD, warp * 16, s * 16, lane));
                ldsm_x4(av, a_addr(vs, LD, warp * 16, s * 16, lane));
#pragma unroll
                for (int np = 0; np < TQ / 16; ++np) {
                    unsigned b[4];
                    ldsm_x4(b, bt_addr(qb, LD, np * 16, s * 16, lane));
                    mma_bf16(p[2 * np], ak, b[0], b[1]);
                    mma_bf16(p[2 * np + 1], ak, b[2], b[3]);
                    ldsm_x4(b, bt_addr(ob, LD, np * 16, s * 16, lane));
                    mma_bf16(ds[2 * np], av, b[0], b[1]);
                    mma_bf16(ds[2 * np + 1], av, b[2], b[3]);
                }
            }
#pragma unroll
            for (int n = 0; n < TQ / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int ql = 8 * n + 2 * t + (e & 1), h = e >> 1;
                    float x = p[n][e];
                    if (kb > 0) x += bb[ql * kb + bcol[h][0]] + bb[ql * kb + bcol[h][1]];
                    const bool in = q0 + ql < lq && jw + g + 8 * h < lk;
                    const float pr = in ? expf(x - sb[3 * ql]) / sb[3 * ql + 1] : 0.0f;
                    p[n][e] = pr;
                    ds[n][e] = pr * (ds[n][e] - sb[3 * ql + 2]);
                }
#pragma unroll
            for (int kq = 0; kq < TQ / 16; ++kq) {  // dv += round(p)^T dO, dk += round(ds)^T qs
                unsigned ap[4], ad[4];
                a_from_c(ap, p[2 * kq], p[2 * kq + 1]);
                a_from_c(ad, ds[2 * kq], ds[2 * kq + 1]);
#pragma unroll
                for (int dn = 0; dn < KD; ++dn) {
                    unsigned b[4];
                    ldsm_x4_t(b, bn_addr(ob, LD, kq * 16, dn * 16, lane));
                    mma_bf16(dva[2 * dn], ap, b[0], b[1]);
                    mma_bf16(dva[2 * dn + 1], ap, b[2], b[3]);
                    ldsm_x4_t(b, bn_addr(qb, LD, kq * 16, dn * 16, lane));
                    mma_bf16(dka[2 * dn], ad, b[0], b[1]);
                    mma_bf16(dka[2 * dn + 1], ad, b[2], b[3]);
                }
            }
        }
        if (next) store(pre, buf ^ 1);
    }

    if (!active) return;
    const long long total = static_cast<long long>(gridDim.x / (splits * ktiles)) * lk * d;  // bh * lk * d
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int j = jw + g + 8 * h;
        if (j >= lk) continue;
#pragma unroll
        for (int n = 0; n < 2 * KD; ++n) {
            const int c = 8 * n + 2 * t;
            if (c >= d) continue;
            const long long o = kbase + static_cast<long long>(j) * d + c;
            if (splits == 1) {
                *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(dka[n][2 * h], dka[n][2 * h + 1]);
                *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(dva[n][2 * h], dva[n][2 * h + 1]);
            } else {
                float* pk = partial + 2 * sp * total;
                *reinterpret_cast<float2*>(pk + o) = make_float2(dka[n][2 * h], dka[n][2 * h + 1]);
                *reinterpret_cast<float2*>(pk + total + o) = make_float2(dva[n][2 * h], dva[n][2 * h + 1]);
            }
        }
    }
}

// dk, dv = the sums of the splits' partials, in split order
__global__ void attn_dkv_reduce(const float* __restrict__ partial, long long total, int splits,
                                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
        float a = 0.0f, b = 0.0f;
        for (int s = 0; s < splits; ++s) {
            a += partial[2 * s * total + i];
            b += partial[(2 * s + 1) * total + i];
        }
        dk[i] = __float2bfloat16(a);
        dv[i] = __float2bfloat16(b);
    }
}

// The head width the tensor-core kernels pad d to (16 KD, KD even), or 0
// when they do not take d.
__host__ __device__ inline int mma_width(int d) {
    if (d <= 0 || d > kMaxD || d % 8 != 0) return 0;
    return round_up(d, 32);
}

struct DkvPlan {
    int warps, ktiles, splits, per_split, smem;
};

// Launch shape of attn_bwd_dkv_mma: 16 keys a warp, 4 to 8 warps; the query
// tiles split across blocks when the grid would not fill the card twice over
DkvPlan dkv_plan(int bh, int lq, int lk, int d, int kb, int sms) {
    DkvPlan p{};
    const int dp = mma_width(d);
    int w = (lk + 15) / 16;
    p.warps = w < 4 ? 4 : (w > 8 ? 8 : w);
    p.ktiles = (lk + 16 * p.warps - 1) / (16 * p.warps);
    const int qtiles = (lq + kDkvQ - 1) / kDkvQ;
    const long long blocks = static_cast<long long>(bh) * p.ktiles;
    p.splits = 1;
    if (blocks < 2LL * sms) {
        const int want = static_cast<int>((4LL * sms + blocks - 1) / blocks);
        const int most = (qtiles + 1) / 2;
        p.splits = want < most ? want : most;
        if (p.splits < 1) p.splits = 1;
    }
    p.per_split = (qtiles + p.splits - 1) / p.splits;
    p.splits = (qtiles + p.per_split - 1) / p.per_split;  // no empty split
    p.smem = dp ? dkv_mma_smem(p.warps, dp, kb) : 0;
    return p;
}

bool dkv_mma_fits(int lk, int d, int kb) {
    const int dp = mma_width(d);
    if (!dp) return false;
    int w = (lk + 15) / 16;
    w = w < 4 ? 4 : (w > 8 ? 8 : w);
    return kDkvQ * (kb + 3) <= kPrefetch * 32 * w && dkv_mma_smem(w, dp, kb) <= kSmemLimit;
}

// The resident tensor-core forward and dq take the bias mode where its keys
// fit; the no-bias mode goes to the streamed kernels at every key length.
bool fwd_mma_fits(int lk, int d, int kb) {
    const int dp = mma_width(d);
    return kb > 0 && dp && fwd_mma_smem(lk, dp, kb) <= kSmemLimit;
}

bool dq_mma_fits(int lk, int d, int kb) {
    const int dp = mma_width(d);
    return kb > 0 && dp && dq_mma_smem(lk, dp, kb) <= kSmemLimit;
}

int sm_count() {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 132;
    return sms;
}

template <int KD, int WARPS>
int fwd_mma_launch_w(const void* qs, const void* k, const void* v, const void* bias, int bh, int lq, int lk, int d,
                     int kh, int kw, void* out, cudaStream_t stream) {
    const int smem = fwd_mma_smem(lk, 16 * KD, kh + kw);
    const cudaError_t err = cudaFuncSetAttribute(attn_fwd_mma<KD, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (lq + 16 * WARPS - 1) / (16 * WARPS);
    using B = __nv_bfloat16;
    attn_fwd_mma<KD, WARPS><<<bh * tiles, 32 * WARPS, smem, stream>>>(
        static_cast<const B*>(qs), static_cast<const B*>(k), static_cast<const B*>(v), static_cast<const B*>(bias), lq,
        lk, d, kh, kw, tiles, static_cast<B*>(out));
    return static_cast<int>(cudaGetLastError());
}

template <int KD>
int fwd_mma_launch(const void* qs, const void* k, const void* v, const void* bias, int bh, int lq, int lk, int d,
                   int kh, int kw, void* out, cudaStream_t stream) {
    return mma_row_warps(lk) == 4 ? fwd_mma_launch_w<KD, 4>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, stream)
                                  : fwd_mma_launch_w<KD, 8>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, stream);
}

template <int KD, int WARPS>
int dq_mma_launch_w(const void* qs, const void* k, const void* v, const void* bias, const void* dout, int bh, int lq,
                  int lk, int d, int kh, int kw, float scale, void* dq, void* dbias, float* stats, cudaStream_t stream) {
    const int smem = dq_mma_smem(lk, 16 * KD, kh + kw);
    const cudaError_t err =
        cudaFuncSetAttribute(attn_bwd_dq_mma<KD, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (lq + 16 * WARPS - 1) / (16 * WARPS);
    using B = __nv_bfloat16;
    attn_bwd_dq_mma<KD, WARPS><<<bh * tiles, 32 * WARPS, smem, stream>>>(
        static_cast<const B*>(qs), static_cast<const B*>(k), static_cast<const B*>(v), static_cast<const B*>(bias),
        static_cast<const B*>(dout), lq, lk, d, kh, kw, tiles, scale, static_cast<B*>(dq), static_cast<B*>(dbias), stats);
    return static_cast<int>(cudaGetLastError());
}

template <int KD>
int dq_mma_launch(const void* qs, const void* k, const void* v, const void* bias, const void* dout, int bh, int lq,
                  int lk, int d, int kh, int kw, float scale, void* dq, void* dbias, float* stats, cudaStream_t stream) {
    return mma_row_warps(lk) == 4
               ? dq_mma_launch_w<KD, 4>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, stream)
               : dq_mma_launch_w<KD, 8>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, stream);
}

template <int KD>
int dkv_mma_launch(const void* qs, const void* k, const void* v, const void* bias, const void* dout,
                   const float* stats, int bh, int lq, int lk, int d, int kh, int kw, void* dk, void* dv,
                   float* scratch, cudaStream_t stream) {
    const DkvPlan p = dkv_plan(bh, lq, lk, d, kh + kw, sm_count());
    if (p.splits > 1 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkv_mma<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    using B = __nv_bfloat16;
    attn_bwd_dkv_mma<KD><<<bh * p.ktiles * p.splits, 32 * p.warps, p.smem, stream>>>(
        static_cast<const B*>(qs), static_cast<const B*>(k), static_cast<const B*>(v), static_cast<const B*>(bias),
        static_cast<const B*>(dout), stats, lq, lk, d, kh, kw, p.ktiles, p.splits, p.per_split, static_cast<B*>(dk),
        static_cast<B*>(dv), scratch);
    int e = static_cast<int>(cudaGetLastError());
    if (e || p.splits == 1) return e;
    const long long total = static_cast<long long>(bh) * lk * d;
    const long long blocks = (total + 255) / 256;
    attn_dkv_reduce<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(scratch, total, p.splits,
                                                                                      static_cast<B*>(dk), static_cast<B*>(dv));
    return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

constexpr int kChunkF = 64;  // keys a chunk of the FFMA forward and dq where not all keys fit

struct FfmaPlan {
    int rows, chunk;  // query rows a block (0: the shape does not fit) and keys a chunk
};

// Launch shape of the FFMA forward (which = 0) or dq kernel (1): every key
// resident (chunk = lk) at the most query rows that fit (forward 32, 16 or
// 8; dq 16 or 8: at 32 rows ptxas spilled it); else kChunkF-key chunks, where
// only the whole score tile grows with Lk.
template <typename T>
FfmaPlan ffma_plan(int which, int lk, int d, int kb) {
    const int chunks[2] = {lk, lk < kChunkF ? lk : kChunkF}, rows[3] = {32, 16, 8};
    for (int ck : chunks)
        for (int tq : rows)
            if (which == 0 ? fwd_smem<T>(tq, lk, ck, d, kb) <= kSmemLimit
                           : tq < 32 && dq_smem<T>(tq, lk, ck, d, kb) <= kSmemLimit)
                return {tq, ck};
    return {0, 0};
}

// The streamed tensor-core kernels take the no-bias mode at any key length.
bool stream_mma_takes(int d, int kb) { return kb == 0 && mma_width(d) != 0; }

template <typename T>
int tile_rows(int which, int lk, int d, int kb) {
    if (sizeof(T) == 2 && which == 0 && fwd_mma_fits(lk, d, kb)) return 16 * mma_row_warps(lk);
    if (sizeof(T) == 2 && which == 0 && stream_mma_takes(d, kb)) return 16 * kStreamWarps;
    if (sizeof(T) == 2 && which == 1) {
        if (dq_mma_fits(lk, d, kb)) return 16 * mma_row_warps(lk);
        return stream_mma_takes(d, kb) ? 16 * kStreamWarps : 0;
    }
    if (sizeof(T) == 2 && which == 2) return dkv_mma_fits(lk, d, kb) ? kDkvQ : 0;
    if (which < 2) return ffma_plan<T>(which, lk, d, kb).rows;
    return dkv_smem<T>(d, kb) <= kSmemLimit ? kTQ2 : 0;
}

template <typename T, int TQ>
int fwd_launch(const void* qs, const void* k, const void* v, const void* bias, int bh, int lq, int lk, int d,
               int kh, int kw, int ck, void* out, cudaStream_t stream) {
    const int smem = fwd_smem<T>(TQ, lk, ck, d, kh + kw);
    const int err = prepare(attn_fwd_kernel<T, TQ>, smem);
    if (err) return err;
    const int tiles = (lq + TQ - 1) / TQ;
    attn_fwd_kernel<T, TQ><<<bh * tiles, kThreads, smem, stream>>>(
        static_cast<const T*>(qs), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(bias),
        lq, lk, d, kh, kw, tiles, ck, static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_ffma(const void* qs, const void* k, const void* v, const void* bias, int bh, int lq, int lk, int d, int kh,
             int kw, void* out, cudaStream_t s) {
    const FfmaPlan p = ffma_plan<T>(0, lk, d, kh + kw);
    switch (p.rows) {
        case 32: return fwd_launch<T, 32>(qs, k, v, bias, bh, lq, lk, d, kh, kw, p.chunk, out, s);
        case 16: return fwd_launch<T, 16>(qs, k, v, bias, bh, lq, lk, d, kh, kw, p.chunk, out, s);
        case 8: return fwd_launch<T, 8>(qs, k, v, bias, bh, lq, lk, d, kh, kw, p.chunk, out, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename T, int TQ>
int dq_launch(const void* qs, const void* k, const void* v, const void* bias, const void* dout, int bh, int lq,
              int lk, int d, int kh, int kw, int ck, float scale, void* dq, void* dbias, float* stats,
              cudaStream_t stream) {
    const int smem = dq_smem<T>(TQ, lk, ck, d, kh + kw);
    const int err = prepare(attn_bwd_dq_kernel<T, TQ>, smem);
    if (err) return err;
    const int tiles = (lq + TQ - 1) / TQ;
    attn_bwd_dq_kernel<T, TQ><<<bh * tiles, kThreads, smem, stream>>>(
        static_cast<const T*>(qs), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(bias),
        static_cast<const T*>(dout), lq, lk, d, kh, kw, tiles, ck, scale, static_cast<T*>(dq), static_cast<T*>(dbias),
        stats);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dkv_launch(const void* qs, const void* k, const void* v, const void* bias, const void* dout,
               const float* stats, int bh, int lq, int lk, int d, int kh, int kw, void* dk, void* dv,
               cudaStream_t stream) {
    const int smem = dkv_smem<T>(d, kh + kw);
    const int err = prepare(attn_bwd_dkv_kernel<T>, smem);
    if (err) return err;
    const int ktiles = (lk + kTK - 1) / kTK;
    attn_bwd_dkv_kernel<T><<<bh * ktiles, kThreads, smem, stream>>>(
        static_cast<const T*>(qs), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(bias),
        static_cast<const T*>(dout), stats, lq, lk, d, kh, kw, ktiles, static_cast<T*>(dk), static_cast<T*>(dv));
    return static_cast<int>(cudaGetLastError());
}

template <int KD>
int fwd_stream_launch(const void* qs, const void* k, const void* v, int bh, int lq, int lk, int d, void* out,
                      cudaStream_t stream) {
    const int smem = fwd_stream_smem(16 * KD);
    const int err = prepare(attn_fwd_mma_stream<KD>, smem);
    if (err) return err;
    const int tiles = (lq + 16 * kStreamWarps - 1) / (16 * kStreamWarps);
    using B = __nv_bfloat16;
    attn_fwd_mma_stream<KD><<<bh * tiles, 32 * kStreamWarps, smem, stream>>>(
        static_cast<const B*>(qs), static_cast<const B*>(k), static_cast<const B*>(v), lq, lk, d, tiles,
        static_cast<B*>(out));
    return static_cast<int>(cudaGetLastError());
}

template <int KD>
int dq_stream_launch(const void* qs, const void* k, const void* v, const void* dout, int bh, int lq, int lk, int d,
                     float scale, void* dq, float* stats, cudaStream_t stream) {
    const int smem = dq_stream_smem(16 * KD);
    const int err = prepare(attn_bwd_dq_mma_stream<KD>, smem);
    if (err) return err;
    const int tiles = (lq + 16 * kStreamWarps - 1) / (16 * kStreamWarps);
    using B = __nv_bfloat16;
    attn_bwd_dq_mma_stream<KD><<<bh * tiles, 32 * kStreamWarps, smem, stream>>>(
        static_cast<const B*>(qs), static_cast<const B*>(k), static_cast<const B*>(v), static_cast<const B*>(dout), lq,
        lk, d, tiles, scale, static_cast<B*>(dq), stats);
    return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int bh, int lq, int lk, int d, int kh, int kw) {
    return bh <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > kMaxD || kh < 0 || kw < 0 || (kh + kw > 0 && kh * kw != lk);
}

}  // namespace

// Query rows per block that kernel `which` (0 forward, 1 dq/dbias, 2 dk/dv)
// takes for these keys, head width and bias width, in bf16 (1) or f32 (0);
// 0 when the shape does not fit in shared memory. In bf16 the forward and dq
// report the tensor-core kernels' rows (resident with a bias: 64 or 128;
// streamed without: 128) where they take the shape; the forward else reports
// the FFMA kernel's.
extern "C" int audiossl_attn_tile(int which, int lk, int d, int kb, int bf16) {
    return bf16 ? tile_rows<__nv_bfloat16>(which, lk, d, kb) : tile_rows<float>(which, lk, d, kb);
}

// q scaled (qs), k, v [bh, lq | lk, d] and bias [bh, lq, kh + kw] (null with
// kh = kw = 0) in one dtype, contiguous; out [bh, lq, d]. Each entry point
// returns cudaGetLastError() after its launch (0 on success), launches on
// `stream`, allocates nothing and does not synchronise.
extern "C" int audiossl_attn_fwd(const void* qs, const void* k, const void* v, const void* bias, int bh, int lq,
                                 int lk, int d, int kh, int kw, int bf16, void* out, void* stream) {
    if (bad_shape(bh, lq, lk, d, kh, kw) || (bias == nullptr) != (kh + kw == 0)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16 && fwd_mma_fits(lk, d, kh + kw)) {
        switch (mma_width(d) / 16) {
            case 2: return fwd_mma_launch<2>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s);
            case 4: return fwd_mma_launch<4>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s);
            case 6: return fwd_mma_launch<6>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s);
            case 8: return fwd_mma_launch<8>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    if (bf16 && stream_mma_takes(d, kh + kw)) {
        switch (mma_width(d) / 16) {
            case 2: return fwd_stream_launch<2>(qs, k, v, bh, lq, lk, d, out, s);
            case 4: return fwd_stream_launch<4>(qs, k, v, bh, lq, lk, d, out, s);
            case 6: return fwd_stream_launch<6>(qs, k, v, bh, lq, lk, d, out, s);
            case 8: return fwd_stream_launch<8>(qs, k, v, bh, lq, lk, d, out, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    return bf16 ? fwd_ffma<__nv_bfloat16>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s)
                : fwd_ffma<float>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s);
}

// dout [bh, lq, d]; writes dq [bh, lq, d] (times `scale`), dbias [bh, lq, kh + kw]
// (when there is a bias) and stats [bh, lq, 3] f32 for audiossl_attn_bwd_dkv.
extern "C" int audiossl_attn_bwd_dq(const void* qs, const void* k, const void* v, const void* bias, const void* dout,
                                    int bh, int lq, int lk, int d, int kh, int kw, int bf16, float scale, void* dq,
                                    void* dbias, float* stats, void* stream) {
    if (bad_shape(bh, lq, lk, d, kh, kw) || (bias == nullptr) != (kh + kw == 0)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16 && dq_mma_fits(lk, d, kh + kw)) {
        switch (mma_width(d) / 16) {
            case 2: return dq_mma_launch<2>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, s);
            case 4: return dq_mma_launch<4>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, s);
            case 6: return dq_mma_launch<6>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, s);
            case 8: return dq_mma_launch<8>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    if (bf16) {
        if (!stream_mma_takes(d, kh + kw)) return static_cast<int>(cudaErrorInvalidValue);
        switch (mma_width(d) / 16) {
            case 2: return dq_stream_launch<2>(qs, k, v, dout, bh, lq, lk, d, scale, dq, stats, s);
            case 4: return dq_stream_launch<4>(qs, k, v, dout, bh, lq, lk, d, scale, dq, stats, s);
            case 6: return dq_stream_launch<6>(qs, k, v, dout, bh, lq, lk, d, scale, dq, stats, s);
            case 8: return dq_stream_launch<8>(qs, k, v, dout, bh, lq, lk, d, scale, dq, stats, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    const FfmaPlan p = ffma_plan<float>(1, lk, d, kh + kw);
    switch (p.rows) {
        case 16: return dq_launch<float, 16>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, p.chunk, scale, dq, dbias, stats, s);
        case 8: return dq_launch<float, 8>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, p.chunk, scale, dq, dbias, stats, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// f32 scratch (floats) that audiossl_attn_bwd_dkv needs for these shapes: the
// splits' partial dk and dv when the bf16 kernel splits the query rows, else 0.
extern "C" long long audiossl_attn_dkv_scratch(int bh, int lq, int lk, int d, int kb, int bf16) {
    if (!bf16 || bh <= 0 || lq <= 0 || lk <= 0 || !dkv_mma_fits(lk, d, kb)) return 0;
    const DkvPlan p = dkv_plan(bh, lq, lk, d, kb, sm_count());
    return p.splits > 1 ? 2LL * p.splits * bh * lk * d : 0;
}

// From the stats audiossl_attn_bwd_dq wrote: dk, dv [bh, lk, d]. `scratch`
// holds audiossl_attn_dkv_scratch(...) floats (null when that is 0).
extern "C" int audiossl_attn_bwd_dkv(const void* qs, const void* k, const void* v, const void* bias, const void* dout,
                                     const float* stats, int bh, int lq, int lk, int d, int kh, int kw, int bf16,
                                     void* dk, void* dv, float* scratch, void* stream) {
    if (bad_shape(bh, lq, lk, d, kh, kw) || (bias == nullptr) != (kh + kw == 0)) return static_cast<int>(cudaErrorInvalidValue);
    if (audiossl_attn_tile(2, lk, d, kh + kw, bf16) == 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16) {
        switch (mma_width(d) / 16) {
            case 2: return dkv_mma_launch<2>(qs, k, v, bias, dout, stats, bh, lq, lk, d, kh, kw, dk, dv, scratch, s);
            case 4: return dkv_mma_launch<4>(qs, k, v, bias, dout, stats, bh, lq, lk, d, kh, kw, dk, dv, scratch, s);
            case 6: return dkv_mma_launch<6>(qs, k, v, bias, dout, stats, bh, lq, lk, d, kh, kw, dk, dv, scratch, s);
            case 8: return dkv_mma_launch<8>(qs, k, v, bias, dout, stats, bh, lq, lk, d, kh, kw, dk, dv, scratch, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    return dkv_launch<float>(qs, k, v, bias, dout, stats, bh, lq, lk, d, kh, kw, dk, dv, s);
}
