// AudioNTT block 1 on Hopper: Conv3x3 (C_in = 1) -> BatchNorm -> ReLU -> MaxPool 2x2,
// forward and its two backward passes, on the reference layout x [B, 1, F, T].
//
// Replaces the TPU kernels of audiossl_tpu/ops/block1.py:
//   block1_fwd        <- _apply_kernel (:174), the fused_block1 forward
//   block1_bwd_sums   <- _bwd1_kernel  (:216), per-channel sum(dy), sum(dy * y_raw)
//   block1_bwd_weight <- _bwd2_kernel  (:235), dW [C, 1, 3, 3] and dbias [C]
// Like the TPU kernels, none of them writes the [B, C, F, T] conv activation:
// the forward writes only the pooled [B, C, F/2, T/2] output, and both backward
// passes recompute the conv from x.
//
// What is computed (per channel c, per position (f, t), with x zero-padded by one):
//   y_raw = sum_{di,dj} w[c][di][dj] * x[f+di-1][t+dj-1] + bias[c]   (9 f32 FMAs)
//   forward:  out = max over the 2x2 window of relu(q * a + (b2 + bias * a)),
//             q = y_raw - bias (the TPU kernel folds the bias into the shift)
//   backward: bn = y_raw * a + b2; dy = dp routed to the window's FIRST maximum of
//             relu(bn) in the JAX package's time-major order (t0,f0), (t0,f1),
//             (t1,f0), (t1,f1) (ops/block1.py:188-213), times relu'(bn).
//             Pass 1 sums dy and dy * y_raw; pass 2 contracts
//             d_conv = k1 * dy + k2 * y_raw + k3 with the shifted x into dW and sums
//             it into dbias.
// Per-channel values come in as params [C, 16] f32: w[0..8] (the weights rounded
// to the stream dtype, as the TPU kernel's banded matrix is), bias, a, b2, k1,
// k2, k3. Inputs are f32 or bf16; bf16 operands are exact in f32, so the conv
// feeds BN without a bf16 round trip (ops/block1.py:38-42).
//
// Bound on an H100 SXM at one training view (B = 256, F = 64 mels, T = 96 frames,
// C = 64, bf16): the forward needs 256*64*64*96 = 100.7 M conv outputs x 9 MACs =
// 1.81 GFLOP and moves 3.1 MB of x in and 50.3 MB of pooled output out. At
// 3.35 TB/s the bytes take about 16 us, 15 of them the write of the pooled output;
// the operations take about 2 us at the 989 TFLOP/s bf16 rate (27 us as f32
// FFMA). So the function is bound by bytes. Backward pass 1 reads x and dp
// (53.4 MB, the same 16 us) and recomputes the 1.81 GFLOP; pass 2 adds the dW
// contraction, 3.6 GFLOP in all.
//
// f32, any width (block1_fwd_kernel, block1_bwd_kernel): one block of 256 threads
// per (clip, tile of R pooled rows). The block stages the tile's 2R + 2 input rows
// and the one-sample halo, zero-padded, in shared memory as f32, and the
// per-channel params beside them. Each warp takes channels warp, warp + 8, ...;
// its lanes walk the tile's pooled positions, load each 4 x 4 input patch and
// compute the four conv outputs of its window with f32 FFMAs. This design is
// bound by shared-memory loads: 16 a pooled position and channel, the patch
// reloaded for every channel.
//
// bf16, the training path (block1_fwd_mma_kernel, block1_bwd_mma_kernel; C = 64
// only): the conv runs on bf16 mma.sync m16n8k16 tiles with f32 accumulation, and
// each input patch is read once for all 64 channels.
//   - A persistent grid (as many 256-thread blocks as fit the card at once) walks
//     items (clip, 16 pooled rows); a block stages the item's input rows (bf16,
//     zero-padded) by 4-byte async copies, and warps take 16 pooled positions at a
//     time. The products are exact, and the conv stays f32, rounded once.
//   - Forward: bound by writing its output. K = 16 is the whole 4 x 4 input patch of
//     a pooled position, and the m-tiles are (window element, 16 channels), each
//     window element's 3 x 3 weights placed at its offset in the patch: each B
//     register is then a pair of one patch row (two tile words joined by one byte
//     permute), and a lane's C fragments hold the four window elements of its
//     positions in four m-tiles. The bias stays out of the product (the TPU kernel's
//     fold), and the sign s of a goes into the weights: q a = (s q) |a| exactly, and
//     fmaf rounds monotonically in s q, so a window's output is
//     relu(fmaf(max_e s q_e, |a|, b2 + bias a)): 3 max and 1 FMA a window and
//     channel, the relu in the bf16 conversion. Two warps share a group, 32 channels
//     each, with their A fragments, |a| and the shift in registers for the whole
//     kernel. A lane holds 4 consecutive pooled positions of each of its channels and
//     writes them in one 8-byte store: the 4 lanes of a quad fill one 32-byte sector
//     of a channel's row. On an H100 SXM (700 W) at the view it takes 0.026 ms, 1.6x
//     its bound; the same stores with the conv replaced by constants take 0.023 ms,
//     and staging the item's output in shared memory for one bulk copy a channel
//     took 0.039 ms.
//   - Backward conv: Y^T[c, pos] = W^T[c, tap] Patch^T[tap, pos], 9 taps and the bias
//     (split exactly into three bf16 terms against rows of ones) padded to K = 16.
//     Columns are ordered so that a lane's C fragments hold all four window elements
//     of its pooled positions (column 2 j + df of n-tile dt): the first-maximum
//     routing runs in registers, in the time-major order.
//   - Pass 1 sums dy and dy * y_raw; a warp takes all 64 channels.
//   - Pass 2: d_conv = k2 y_raw + (k3 + k1 dy) (f32) is split exactly into three
//     bf16 terms (hi + mid + lo, 24 significant bits), which as B fragments (rows
//     positions, columns channels: the conv's C layout) give
//     dW^T[tap, c] += Patch^T[tap, pos] d_conv[pos, c] in three exact products a
//     tile; dbias is the f32 sum of d_conv. Two warps share a group of positions,
//     32 channels each, so that a lane's dW accumulators stay in registers across
//     the block's items.
//   - What bounds the backward passes: instruction issue, no longer shared-memory
//     loads. The compiled loops spend about 31 instructions a window and channel in
//     pass 1 (the f32 routing most of them) and 84 in pass 2 (the split 22 of them);
//     at the card's issue rate that is roughly 60% of each kernel's time. Reading dp
//     (50.3 MB, one 8-byte load a lane and channel) needs 15 us at 3.35 TB/s.
// Both backward designs reduce in a fixed order: over a quad with shuffles, over a
// block's warps through shared memory, one partial row per block; a second kernel
// sums the partials over blocks in block order (one warp an output, a fixed shuffle
// tree). No float atomics, so two runs give the same gradients bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;  // pooled rows per block
constexpr int kParams = 16;  // per-channel f32 params
constexpr int kBias = 9, kA = 10, kB2 = 11, kK1 = 12, kK2 = 13, kK3 = 14;
constexpr size_t kSmemLimit = 48 * 1024;  // the default dynamic shared-memory limit

size_t smem_bytes(int rows, int T, int C) {
    return ((size_t)(2 * rows + 2) * (T + 2) + (size_t)C * kParams) * sizeof(float);
}

// Pooled rows per block: at most kMaxRows and F/2, fewer for long clips so that
// the tile fits the default shared-memory limit; 0 if not even one row fits.
int rows_per_block(int F, int T, int C) {
    int r = kMaxRows < F / 2 ? kMaxRows : F / 2;
    while (r > 0 && smem_bytes(r, T, C) > kSmemLimit) --r;
    return r;
}

// Shared memory: params [C * kParams] | tile [(2R + 2) x (T + 2)]. Tile row r is
// input row f = 2 * p0 - 1 + r, tile column j is input column t = j - 1.
__device__ void stage(const float* __restrict__ x, const float* __restrict__ params, float* prm,
                      float* tile, int b, int p0, int R, int F, int T, int C) {
    for (int i = threadIdx.x; i < C * kParams; i += blockDim.x) prm[i] = params[i];
    const int W = T + 2, H = 2 * R + 2;
    const float* xb = x + (size_t)b * F * T;
    for (int i = threadIdx.x; i < H * W; i += blockDim.x) {
        const int r = i / W, j = i - r * W;
        const int f = 2 * p0 - 1 + r, t = j - 1;
        tile[i] = (f >= 0 && f < F && t >= 0 && t < T) ? xb[(size_t)f * T + t] : 0.f;
    }
}

// The 4 x 4 input patch of pooled position (pr, q) of the tile.
__device__ __forceinline__ void load_patch(const float* tile, int W, int pr, int q, float p[4][4]) {
    const float* base = tile + (2 * pr) * W + 2 * q;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) p[u][v] = base[u * W + v];
}

// Window element k in the TPU kernel's quadrant order: (t0,f0), (t0,f1), (t1,f0), (t1,f1).
__device__ __forceinline__ int dfk(int k) { return k & 1; }
__device__ __forceinline__ int dtk(int k) { return k >> 1; }

// conv (no bias) of window element k.
__device__ __forceinline__ float conv_at(const float p[4][4], const float w[9], int k) {
    const int df = dfk(k), dt = dtk(k);
    float s = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) s = fmaf(w[di * 3 + dj], p[df + di][dt + dj], s);
    return s;
}

// Shared backward recompute: y_raw and the routed dy of the four window elements.
__device__ __forceinline__ void recompute_dy(const float p[4][4], const float w[9], float bias, float a,
                                             float b2, float dpv, float yr[4], float dy[4]) {
    float bn[4], o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        yr[k] = conv_at(p, w, k) + bias;
        bn[k] = yr[k] * a + b2;
        o[k] = fmaxf(bn[k], 0.f);
    }
    const float mx = fmaxf(fmaxf(o[0], o[1]), fmaxf(o[2], o[3]));
    bool taken = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const bool first = (o[k] == mx) && !taken;
        taken = taken || first;
        dy[k] = (first && bn[k] > 0.f) ? dpv : 0.f;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__global__ void __launch_bounds__(kThreads) block1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ params,
                                                              float* __restrict__ out, int F, int T, int C, int R, int tiles) {
    extern __shared__ float smem[];
    float* prm = smem;
    float* tile = smem + C * kParams;
    const int b = blockIdx.x / tiles, p0 = (blockIdx.x - b * tiles) * R;
    stage(x, params, prm, tile, b, p0, R, F, T, C);
    __syncthreads();
    const int Fp = F / 2, Tp = T / 2, W = T + 2;
    const int rows = min(R, Fp - p0), npos = rows * Tp;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = warp; c < C; c += kWarps) {
        const float* pc = prm + c * kParams;
        float w[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) w[k] = pc[k];
        const float a = pc[kA], bapp = pc[kB2] + pc[kBias] * a;
        float* oc = out + ((size_t)b * C + c) * Fp * Tp + (size_t)p0 * Tp;
        for (int pos = lane; pos < npos; pos += 32) {
            const int pr = pos / Tp, q = pos - pr * Tp;
            float p[4][4];
            load_patch(tile, W, pr, q, p);
            float o = 0.f;  // every candidate is a relu output, so 0 is the identity of the max
#pragma unroll
            for (int k = 0; k < 4; ++k) o = fmaxf(o, fmaxf(conv_at(p, w, k) * a + bapp, 0.f));
            oc[pos] = o;
        }
    }
}

// kWeight = false: partial[blk][c] = (sum dy, sum dy * y_raw).
// kWeight = true:  partial[blk][c] = (dW[0..8], dbias) of d_conv = k1 dy + k2 y_raw + k3.
template <bool kWeight>
__global__ void __launch_bounds__(kThreads) block1_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dp,
                                                              const float* __restrict__ params, float* __restrict__ partial,
                                                              int F, int T, int C, int R, int tiles) {
    constexpr int kOut = kWeight ? 10 : 2;
    extern __shared__ float smem[];
    float* prm = smem;
    float* tile = smem + C * kParams;
    const int b = blockIdx.x / tiles, p0 = (blockIdx.x - b * tiles) * R;
    stage(x, params, prm, tile, b, p0, R, F, T, C);
    __syncthreads();
    const int Fp = F / 2, Tp = T / 2, W = T + 2;
    const int rows = min(R, Fp - p0), npos = rows * Tp;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = warp; c < C; c += kWarps) {
        const float* pc = prm + c * kParams;
        float w[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) w[k] = pc[k];
        const float bias = pc[kBias], a = pc[kA], b2 = pc[kB2];
        const float k1 = pc[kK1], k2 = pc[kK2], k3 = pc[kK3];
        const float* dpc = dp + ((size_t)b * C + c) * Fp * Tp + (size_t)p0 * Tp;
        float acc[kOut];
#pragma unroll
        for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
        for (int pos = lane; pos < npos; pos += 32) {
            const int pr = pos / Tp, q = pos - pr * Tp;
            float p[4][4], yr[4], dy[4];
            load_patch(tile, W, pr, q, p);
            recompute_dy(p, w, bias, a, b2, dpc[pos], yr, dy);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                if constexpr (kWeight) {
                    const float dc = k1 * dy[k] + k2 * yr[k] + k3;
                    const int df = dfk(k), dt = dtk(k);
#pragma unroll
                    for (int di = 0; di < 3; ++di)
#pragma unroll
                        for (int dj = 0; dj < 3; ++dj)
                            acc[di * 3 + dj] = fmaf(dc, p[df + di][dt + dj], acc[di * 3 + dj]);
                    acc[9] += dc;
                } else {
                    acc[0] += dy[k];
                    acc[1] = fmaf(dy[k], yr[k], acc[1]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kOut; ++i) acc[i] = warp_sum(acc[i]);
        if (lane == 0) {
            float* dst = partial + ((size_t)blockIdx.x * C + c) * kOut;
#pragma unroll
            for (int i = 0; i < kOut; ++i) dst[i] = acc[i];
        }
    }
}

// out[i] = sum over blocks, in block order, of partial[blk][i]: one warp an output,
// its lanes taking blocks lane, lane + 32, ... in order, then a fixed shuffle tree.
__global__ void reduce_partials_kernel(const float* __restrict__ partial, int nblk, int n, float* __restrict__ out) {
    const int i = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (i >= n) return;
    float s = 0.f;
    for (int k = lane; k < nblk; k += 32) s += partial[(size_t)k * n + i];
    s = warp_sum(s);
    if (lane == 0) out[i] = s;
}

// ---------------------------------------------------------------- bf16 forward and backward on tensor cores
//
// Fragments of mma.sync.m16n8k16 (PTX ISA), lane = 4 g + t4: A (16 x 16) a0 = (row g,
// k 2t4, 2t4 + 1), a1 = (row g + 8, same), a2 = (row g, k 2t4 + 8, 2t4 + 9), a3 = (row
// g + 8, same); B (16 x 8) b0 = (k 2t4, 2t4 + 1, col g), b1 = (k 2t4 + 8, 2t4 + 9, col g);
// C (16 x 8, f32) c0, c1 = (row g, cols 2t4, 2t4 + 1), c2, c3 = (row g + 8, same).
//
// Columns of the backward passes' conv: a warp takes 16 pooled positions at a time as 4
// column pairs p; pooled position base + 4 j + p, window element (df, dt) is column
// 2 j + df of n-tile dt. So a lane's C fragments hold all four window elements of pooled
// position base + 4 t4 + p (its 4 positions over the pairs are consecutive: one 8-byte
// dp load a channel), channels g and g + 8 of each 16-channel m-tile. (The forward's
// layout is at block1_fwd_mma_kernel.)

constexpr int kMmaC = 64;                  // channels of the tensor-core design (AudioNTT's block 1)
constexpr int kGroup = 16;                 // pooled positions a warp takes at a time
constexpr int kMmaRows = 16;               // pooled rows an item
constexpr size_t kMmaSmemMax = 200 * 1024;  // above kSmemLimit only after cudaFuncSetAttribute

// c += a b, bf16 operands, f32 accumulation (not volatile: the compiler may move it
// like any other arithmetic)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 pair (lo, hi) as one register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack_bits(unsigned short lo, unsigned short hi) {
    return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}
__device__ __forceinline__ float lo_f32(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f32(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

// (d0, d1) = hi + mid + lo exactly, as three bf16 pairs: hi takes each value's top 8
// significant bits, the residual d - hi (exact in f32) has at most 16, mid its top 8,
// and the residual after it (exact) the last 8, which lo holds exactly.
__device__ __forceinline__ void split3(float d0, float d1, unsigned (&r)[3]) {
    r[0] = pack_bf16(d0, d1);
    const float r0 = d0 - lo_f32(r[0]), r1 = d1 - hi_f32(r[0]);
    r[1] = pack_bf16(r0, r1);
    r[2] = pack_bf16(r0 - lo_f32(r[1]), r1 - hi_f32(r[1]));
}

// The routing of one window: bn = y_raw * a + b2, one FMA (as the FFMA design's
// compiler contracts it; the plain version rounds twice). dp goes to the first maximum
// of relu(bn) in the time-major order, times relu'(bn) there: that is the first element
// k with bn[k] = max(bn) when max(bn) > 0, and no element otherwise. Returns max(bn);
// e[k] = (bn[k] == max(bn)) for k < 3.
__device__ __forceinline__ float window_max(const float (&yr)[4], float a, float b2, bool (&e)[3]) {
    float bn[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) bn[k] = fmaf(yr[k], a, b2);
    const float mx = fmaxf(fmaxf(bn[0], bn[1]), fmaxf(bn[2], bn[3]));
#pragma unroll
    for (int k = 0; k < 3; ++k) e[k] = bn[k] == mx;
    return mx;
}

// dp at 4 consecutive pooled positions of one channel as two bf16 pairs; zeros past
// `avail`. `vec`: src is 8-byte aligned and avail >= 4 (and so for store4's dst).
__device__ __forceinline__ void load_dp4(const unsigned short* src, int avail, bool vec, unsigned (&r)[2]) {
    if (vec) {
        const uint2 v = __ldcs(reinterpret_cast<const uint2*>(src));
        r[0] = v.x;
        r[1] = v.y;
    } else {
        unsigned short v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = i < avail ? src[i] : 0;
        r[0] = pack_bits(v[0], v[1]);
        r[1] = pack_bits(v[2], v[3]);
    }
}

// two bf16 pairs to 4 consecutive pooled positions of one channel, none past `avail`
__device__ __forceinline__ void store4(unsigned short* dst, int avail, bool vec, unsigned r0, unsigned r1) {
    if (vec) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(r0, r1);
    } else {
        const unsigned short v[4] = {static_cast<unsigned short>(r0), static_cast<unsigned short>(r0 >> 16),
                                     static_cast<unsigned short>(r1), static_cast<unsigned short>(r1 >> 16)};
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (i < avail) dst[i] = v[i];
    }
}

// 4 bytes global -> shared without a register, zero-filled where `valid` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The passes, as the grid query names them
constexpr int kFwd = 0, kSums = 1, kDW = 2;

// Shared memory of the tensor-core kernels: the input tile of (2R + 2) rows x (T + 4)
// columns, bf16 (tile column j is input column j - 2: rows start 4-byte aligned, so they
// arrive by 4-byte async copies); the backward passes put the warps' sums, the conv's A
// fragments and the params in front of it.
size_t mma_smem_bytes(int rows, int T, int pass) {
    const size_t tile = (size_t)(2 * rows + 2) * (T + 4) * sizeof(unsigned short);
    if (pass == kFwd) return tile;
    return (size_t)kWarps * (pass == kDW ? 10 : 2) * kMmaC * sizeof(float) + (size_t)(kMmaC / 16) * 32 * sizeof(uint4) +
           2 * kMmaC * sizeof(float4) + tile;
}

// Pooled rows per item of the tensor-core kernels: at most kMmaRows and F/2, fewer for
// long clips, so that the tile fits kMmaSmemMax; 0 if not even one row fits.
int mma_rows(int F, int T, int pass) {
    int r = kMmaRows < F / 2 ? kMmaRows : F / 2;
    while (r > 0 && mma_smem_bytes(r, T, pass) > kMmaSmemMax) --r;
    return r;
}

// Zero the two columns left and right of every tile row (once a block: staging never
// writes them).
__device__ __forceinline__ void zero_tile_edges(unsigned short* tile, int R, int T) {
    const int W = T + 4;
    for (int r = threadIdx.x; r < 2 * R + 2; r += blockDim.x) {
        unsigned short* row = tile + r * W;
        row[0] = row[1] = row[T + 2] = row[T + 3] = 0;
    }
}

// Stage an item's input rows 2 p0 - 1 .. 2 p0 + 2 rows into the tile, zero past the clip,
// one row a warp; returns when the block's copies have landed. `async_rows`: x is
// 4-byte aligned (T is even: then every row is).
__device__ __forceinline__ void stage_rows(unsigned short* tile, const unsigned short* xb, int p0, int rows, int F,
                                           int T, bool async_rows) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, W = T + 4;
    __syncthreads();  // every warp is done with the last item's tile
    for (int r = warp; r < 2 * rows + 2; r += kWarps) {
        const int f = 2 * p0 - 1 + r;
        const bool in = f >= 0 && f < F;
        const unsigned short* src = in ? xb + (size_t)f * T : xb;
        unsigned short* dst = tile + r * W + 2;
        if (async_rows)
            for (int j = 2 * lane; j < T; j += 64) cp_async4(dst + j, src + j, in);
        else
            for (int j = lane; j < T; j += 32) dst[j] = in ? src[j] : 0;
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
}

// bf16 pair (lo, hi) as one register, each relu'd: cvt.rn.relu puts its first operand in
// the high half
__device__ __forceinline__ unsigned pack_bf16_relu(float lo, float hi) {
    unsigned r;
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

// out [B, 64, F/2, T/2] bf16 = max over the 2x2 window of relu(q a + sh), sh = b2 + bias a
// rounded as the plain version rounds it. A persistent block walks items (clip, R pooled
// rows) blockIdx.x, + gridDim.x, ...; two warps share a group of 16 pooled positions, 32
// channels each, four pairs a block.
//
// The conv as products with the whole 4 x 4 input patch of a pooled position (K = 16, k =
// 4 u + v for patch row u, column v): window element e = (df, dt) of channel c is row
// (e, c) of W', its 3 x 3 weights (times the sign s of a) at patch offset (df, dt) and
// zeros elsewhere. A warp's m-tiles are (e, 16 channels): 4 window elements x its 2
// channel tiles, A fragments in registers for the whole kernel. Column g of n-tile nt is
// pooled position base + 4 (g / 2) + 2 nt + g % 2; b0 and b1 are patch rows t4 / 2 and
// t4 / 2 + 2, columns 2 (t4 % 2), + 1: two halves that straddle two words of the tile
// (input columns 2 q - 1 + v, + 1 sit at tile columns 2 q + 1 + v, + 1), joined by one
// byte permute. A lane's C fragments hold, for channels g and g + 8 of each m-tile, the
// consecutive pooled positions base + 4 t4 .. + 3 over the two n-tiles: the window's max
// is taken over the 4 m-tiles of a channel tile, in registers, and one 8-byte store a
// channel writes the 4 positions.
__global__ void __launch_bounds__(kThreads, 2) block1_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                                                                     const float* __restrict__ params,
                                                                     __nv_bfloat16* __restrict__ out, int F, int T,
                                                                     int R, int tiles, int items) {
    extern __shared__ float smem[];
    unsigned short* tile = reinterpret_cast<unsigned short*>(smem);  // bf16 [(2R + 2) x (T + 4)]
    const unsigned* tile32 = reinterpret_cast<const unsigned*>(smem);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
    const int half = warp & 1, pw = warp >> 1;  // channels 32 half .. + 31; the pair's groups pw, pw + 4, ...
    const int Fp = F / 2, Tp = T / 2, W = T / 2 + 2;  // W: the tile's row in words
    zero_tile_edges(tile, R, T);
    unsigned wa[2][4][4];      // A fragments [channel tile][window element]
    float aa[2][2], sh[2][2];  // |a| and the shift of channel 32 half + 16 ct + 8 h + g
    const int u = t4 >> 1, v = 2 * (t4 & 1);  // this lane's k = 4 u + v, + 1 (and u + 2)
#pragma unroll
    for (int ct = 0; ct < 2; ++ct) {
        const float* pc[2];
        float s[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            pc[h] = params + (32 * half + 16 * ct + 8 * h + g) * kParams;
            const float a = pc[h][kA];
            s[h] = a < 0.f ? -1.f : 1.f;
            aa[ct][h] = fabsf(a);
            sh[ct][h] = __fadd_rn(pc[h][kB2], __fmul_rn(pc[h][kBias], a));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            // W'[k = 4 u + v] = s w[u - df][v - dt] where that is a tap, else 0 (a load, not
            // a register array indexed at run time)
            auto wp = [&](int h, int uu, int vv) {
                const int di = uu - dfk(e), dj = vv - dtk(e);
                return di >= 0 && di < 3 && dj >= 0 && dj < 3 ? s[h] * pc[h][di * 3 + dj] : 0.f;
            };
            wa[ct][e][0] = pack_bf16(wp(0, u, v), wp(0, u, v + 1));
            wa[ct][e][1] = pack_bf16(wp(1, u, v), wp(1, u, v + 1));
            wa[ct][e][2] = pack_bf16(wp(0, u + 2, v), wp(0, u + 2, v + 1));
            wa[ct][e][3] = pack_bf16(wp(1, u + 2, v), wp(1, u + 2, v + 1));
        }
    }
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
    unsigned short* os = reinterpret_cast<unsigned short*>(out);
    const size_t plane = (size_t)Fp * Tp;
    // 8-byte stores where every item's positions start 4-aligned
    const bool out_vec = (reinterpret_cast<size_t>(out) & 7) == 0 && plane % 4 == 0 && ((size_t)R * Tp) % 4 == 0;
    const bool async_rows = (reinterpret_cast<size_t>(x) & 3) == 0;
    // a pair's stride of positions, in (row, column)
    const int stride = kWarps / 2 * kGroup, step_r = stride / Tp, step_q = stride % Tp;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / tiles, p0 = (item - b * tiles) * R;
        const int rows = min(R, Fp - p0), npos = rows * Tp;
        stage_rows(tile, xs + (size_t)b * F * T, p0, rows, F, T, async_rows);
        // this lane's channel 32 half + g at this item's first position
        unsigned short* ob = os + ((size_t)b * kMmaC + 32 * half + g) * plane + (size_t)p0 * Tp;
        // (row, column) of column g of n-tile 0: pooled position base + 4 (g / 2) + g % 2
        const int pos0 = pw * kGroup + 4 * (g >> 1) + (g & 1);
        int pr = pos0 / Tp, q = pos0 - pr * Tp;
        for (int base = pw * kGroup; base < npos; base += stride) {
            // B fragments of n-tiles 0 and 1 (n-tile 1: two positions on); past the item the
            // row is clamped: those columns are never stored
            unsigned bf[2][2];
            {
                int pr1 = pr, q1 = q + 2;
                while (q1 >= Tp) q1 -= Tp, ++pr1;
                const unsigned* s0 = tile32 + (2 * min(pr, rows - 1) + u) * W + q + (t4 & 1);
                const unsigned* s1 = tile32 + (2 * min(pr1, rows - 1) + u) * W + q1 + (t4 & 1);
                bf[0][0] = __byte_perm(s0[0], s0[1], 0x5432);  // the high half of one word, the low of the next
                bf[0][1] = __byte_perm(s0[2 * W], s0[2 * W + 1], 0x5432);
                bf[1][0] = __byte_perm(s1[0], s1[1], 0x5432);
                bf[1][1] = __byte_perm(s1[2 * W], s1[2 * W + 1], 0x5432);
            }
            q += step_q, pr += step_r;
            if (q >= Tp) q -= Tp, ++pr;
            const int q0 = base + 4 * t4;  // this lane's pooled positions q0 .. q0 + 3
            const bool vec = out_vec && q0 + 4 <= npos;
#pragma unroll
            for (int ct = 0; ct < 2; ++ct) {
                unsigned o[2][2];  // [h][n-tile]: positions q0 + 2 nt, + 1 of channel 16 ct + 8 h + g
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    float y[4][4];  // [window element][c0..c3]
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        y[e][0] = y[e][1] = y[e][2] = y[e][3] = 0.f;
                        mma_bf16(y[e], wa[ct][e], bf[nt][0], bf[nt][1]);
                    }
                    float z[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float mx = fmaxf(fmaxf(y[0][i], y[1][i]), fmaxf(y[2][i], y[3][i]));
                        z[i] = fmaf(mx, aa[ct][i >> 1], sh[ct][i >> 1]);
                    }
                    o[0][nt] = pack_bf16_relu(z[0], z[1]);
                    o[1][nt] = pack_bf16_relu(z[2], z[3]);
                }
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    store4(ob + (size_t)(16 * ct + 8 * h) * plane + q0, npos - q0, vec, o[h][0], o[h][1]);
            }
        }
    }
}

// kWeight = false: partial[blk][c] = (sum dy, sum dy * y_raw).
// kWeight = true:  partial[blk][c] = (dW[0..8], dbias) of d_conv = k1 dy + k2 y_raw + k3.
// A persistent block walks items (clip, R pooled rows) blockIdx.x, + gridDim.x, ...; a
// warp takes 16 pooled positions at a time. In the sums pass a warp takes all 64
// channels; in the weight pass two warps share the positions, 32 channels each, so
// that a lane's 32 dW accumulators fit its registers. The conv's A fragments (one
// 16-byte load a lane and m-tile) and the params (one or two a channel and window)
// come from shared memory.
template <bool kWeight>
__global__ void __launch_bounds__(kThreads, 2) block1_bwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                                                                     const __nv_bfloat16* __restrict__ dp,
                                                                     const float* __restrict__ params,
                                                                     float* __restrict__ partial, int F, int T, int R,
                                                                     int tiles, int items) {
    constexpr int C = kMmaC, kOut = kWeight ? 10 : 2;
    constexpr int kMT = kWeight ? 2 : 4;  // 16-channel m-tiles a warp takes
    constexpr int kShare = 4 / kMT;       // warps that share a group of positions
    extern __shared__ float smem[];
    float* red = smem;                                                       // [kWarps][C][kOut]: each warp's sums
    uint4* wfrag = reinterpret_cast<uint4*>(red + kWarps * C * kOut);        // [C / 16][32]: the conv's A fragments
    float4* prm4 = reinterpret_cast<float4*>(wfrag + C / 16 * 32);           // [C][2]: a, b2, k1, k2 | k3, -
    unsigned short* tile = reinterpret_cast<unsigned short*>(prm4 + 2 * C);  // bf16 [(2R + 2) x (T + 4)]
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
    const int m0 = (warp % kShare) * kMT, gwarp = warp / kShare, gstep = kWarps / kShare * kGroup;
    const int Fp = F / 2, Tp = T / 2, W = T + 4;
    // tap k = 3 di + dj of the window at tile row 2 pr, column 2 q + 1 (input column 2 q - 1)
    // sits di * W + dj further
    const int off0 = (2 * t4) / 3 * W + (2 * t4) % 3, off1 = (2 * t4 + 1) / 3 * W + (2 * t4 + 1) % 3;
    const int offg = g / 3 * W + g % 3, off8 = 2 * W + 2;
    zero_tile_edges(tile, R, T);
    if (warp < C / 16) {
        // the A fragments of m-tile `warp`: rows c = 16 m + g (+ 8); k = taps 0..8 (the weights,
        // already bf16), then the bias split exactly into three bf16 terms (k = 9, 10, 11, whose
        // B rows are ones), so that the tensor core adds it; the rest zero
        const float* pc = params + (16 * warp + g) * kParams;
        float bt[2][3];  // hi, mid, lo of rows g and g + 8
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float b = pc[8 * h * kParams + kBias];
            bt[h][0] = __bfloat162float(__float2bfloat16_rn(b));
            bt[h][1] = __bfloat162float(__float2bfloat16_rn(b - bt[h][0]));
            bt[h][2] = (b - bt[h][0]) - bt[h][1];
        }
        auto w = [&](int h, int k) { return k < 9 ? pc[8 * h * kParams + k] : k < 12 ? bt[h][k - 9] : 0.f; };
        wfrag[warp * 32 + lane] =
            make_uint4(pack_bf16(w(0, 2 * t4), w(0, 2 * t4 + 1)), pack_bf16(w(1, 2 * t4), w(1, 2 * t4 + 1)),
                       pack_bf16(w(0, 2 * t4 + 8), w(0, 2 * t4 + 9)), pack_bf16(w(1, 2 * t4 + 8), w(1, 2 * t4 + 9)));
    }
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const float* pc = params + c * kParams;
        prm4[2 * c] = make_float4(pc[kA], pc[kB2], pc[kK1], pc[kK2]);
        prm4[2 * c + 1] = make_float4(pc[kK3], 0.f, 0.f, 0.f);
    }
    float acc[kMT][2][2];                // sums: (sum dy, sum dy * y_raw); weight: (dbias, -)
    float dw[kWeight ? 2 * kMT : 1][4];  // weight: C fragments of dW^T, n-tile n = 8 channels, rows taps g, g + 8
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) acc[m][h][0] = acc[m][h][1] = 0.f;
    if constexpr (kWeight)
#pragma unroll
        for (int n = 0; n < 2 * kMT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dw[n][e] = 0.f;
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
    const unsigned short* dps = reinterpret_cast<const unsigned short*>(dp);
    const size_t plane = (size_t)Fp * Tp;
    // dp at 8-byte loads where every item's positions start 4-aligned
    const bool dp_vec = (reinterpret_cast<size_t>(dp) & 7) == 0 && plane % 4 == 0 && ((size_t)R * Tp) % 4 == 0;
    const bool async_rows = (reinterpret_cast<size_t>(x) & 3) == 0;  // T is even: every row is 4-byte aligned
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / tiles, p0 = (item - b * tiles) * R;
        const int rows = min(R, Fp - p0), npos = rows * Tp;
        stage_rows(tile, xs + (size_t)b * F * T, p0, rows, F, T, async_rows);
        const unsigned short* dpb = dps + (size_t)b * C * plane + (size_t)p0 * Tp;
        for (int base = gwarp * kGroup; base < npos; base += gstep) {
            const int q0 = base + 4 * t4;  // this lane's pooled positions q0 .. q0 + 3, one a pair
            unsigned dpr[kMT][2][2];
            const bool vec = dp_vec && q0 + 4 <= npos;
#pragma unroll
            for (int m = 0; m < kMT; ++m)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    load_dp4(dpb + (size_t)(16 * (m0 + m) + 8 * h + g) * plane + q0, npos - q0, vec, dpr[m][h]);
            // (row, column) of the pooled positions of pair 0: the B loader's column and this lane's own
            int pr_b = (base + 4 * (g >> 1)) / Tp, q_b = base + 4 * (g >> 1) - pr_b * Tp;
            int pr_c = q0 / Tp, q_c = q0 - pr_c * Tp;
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                // B fragments of the conv: column g is pooled position base + 4 (g / 2) + p, window row
                // g % 2. Past the item the row is clamped: those columns' outputs are never read.
                unsigned bf[2][2];  // [dt][b0, b1]
                {
                    const unsigned short* s = tile + (2 * min(pr_b, rows - 1) + (g & 1)) * W + 2 * q_b + 1;
#pragma unroll
                    for (int dt = 0; dt < 2; ++dt) {
                        bf[dt][0] = pack_bits(s[dt + off0], s[dt + off1]);
                        // tap 8 and the ones of the bias rows (bf16 1.0 = 0x3f80)
                        bf[dt][1] = t4 == 0 ? pack_bits(s[dt + off8], 0x3f80) : t4 == 1 ? 0x3f803f80u : 0u;
                    }
                }
                const bool valid = q0 + p < npos;  // this lane's C fragments' pooled position
                // weight: A fragment of dW^T = Patch^T d_conv: rows taps g (and 8 for g = 0), k =
                // columns 2 t4 + df of n-tile dt, i.e. this lane's own window elements. Zero past
                // the item, where d_conv is not.
                unsigned pa[4];
                if constexpr (kWeight) {
                    const unsigned short* s = tile + 2 * min(pr_c, rows - 1) * W + 2 * q_c + 1;
                    const unsigned keep = valid ? 0xffffffffu : 0u, keep8 = g == 0 ? keep : 0u;
                    pa[0] = pack_bits(s[offg], s[offg + W]) & keep;
                    pa[2] = pack_bits(s[offg + 1], s[offg + W + 1]) & keep;
                    pa[1] = pack_bits(s[off8], s[off8 + W]) & keep8;
                    pa[3] = pack_bits(s[off8 + 1], s[off8 + W + 1]) & keep8;
                }
                if (++q_b == Tp) q_b = 0, ++pr_b;
                if (++q_c == Tp) q_c = 0, ++pr_c;
#pragma unroll
                for (int m = 0; m < kMT; ++m) {
                    const uint4 wv = wfrag[(m0 + m) * 32 + lane];
                    const unsigned wa[4] = {wv.x, wv.y, wv.z, wv.w};
                    float y0[4] = {0.f, 0.f, 0.f, 0.f}, y1[4] = {0.f, 0.f, 0.f, 0.f};
                    mma_bf16(y0, wa, bf[0][0], bf[0][1]);
                    mma_bf16(y1, wa, bf[1][0], bf[1][1]);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        // a, b2 (, k1, k2, k3) of channel 16 (m0 + m) + 8 h + g
                        const int c = 16 * (m0 + m) + 8 * h + g;
                        const float4 u = prm4[2 * c];
                        const float pc[5] = {u.x, u.y, u.z, u.w, kWeight ? prm4[2 * c + 1].x : 0.f};
                        // y_raw (the bias added by the tensor core) of the window elements in the
                        // time-major order (t0,f0), (t0,f1), (t1,f0), (t1,f1)
                        const float yr[4] = {y0[2 * h], y0[2 * h + 1], y1[2 * h], y1[2 * h + 1]};
                        const unsigned dpw = dpr[m][h][p >> 1];  // zero past the item
                        const float dpv = (p & 1) ? hi_f32(dpw) : lo_f32(dpw);
                        bool e[3];
                        const float mx = window_max(yr, pc[0], pc[1], e);
                        const float dpe = mx > 0.f ? dpv : 0.f;
                        if constexpr (!kWeight) {
                            // the other three elements' dy are 0: adding them changes no bit
                            const float ysel = e[0] ? yr[0] : e[1] ? yr[1] : e[2] ? yr[2] : yr[3];
                            acc[m][h][0] += dpe;
                            acc[m][h][1] = fmaf(dpe, ysel, acc[m][h][1]);
                        } else {
                            // d_conv = k2 y_raw + (k3 + k1 dy): dy is dpe at the first maximum, else 0
                            const float k3 = pc[4], k3t = fmaf(pc[2], dpe, k3);
                            const float dc[4] = {fmaf(pc[3], yr[0], e[0] ? k3t : k3),
                                                 fmaf(pc[3], yr[1], !e[0] && e[1] ? k3t : k3),
                                                 fmaf(pc[3], yr[2], !e[0] && !e[1] && e[2] ? k3t : k3),
                                                 fmaf(pc[3], yr[3], !e[0] && !e[1] && !e[2] ? k3t : k3)};
                            // dbias: the f32 sum of d_conv (zero past the item)
                            acc[m][h][0] = fmaf(((dc[0] + dc[1]) + dc[2]) + dc[3], valid ? 1.f : 0.f, acc[m][h][0]);
                            // B of dW^T, one a term: rows k = (dt, df) of this lane's position (b0: dt = 0,
                            // b1: dt = 1), column its channel
                            unsigned b0[3], b1[3];
                            split3(dc[0], dc[1], b0);
                            split3(dc[2], dc[3], b1);
#pragma unroll
                            for (int j = 0; j < 3; ++j) mma_bf16(dw[2 * m + h], pa, b0[j], b1[j]);
                        }
                    }
                }
            }
        }
    }
    // the block's partial row: each warp's rows, then their sum over warps in order
    float* rw = red + warp * C * kOut;
    if constexpr (kWeight) {
        for (int i = lane; i < C * kOut; i += 32) rw[i] = 0.f;  // the channels of the other warp of the pair
        __syncwarp();
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // over the quad (the lanes of one g)
            float v[2] = {acc[m][h][0], acc[m][h][1]};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
                v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
            }
            const int c = 16 * (m0 + m) + 8 * h + g;
            if (t4 == 0) {
                if constexpr (kWeight)
                    rw[c * kOut + 9] = v[0];
                else
                    rw[c * kOut] = v[0], rw[c * kOut + 1] = v[1];
            }
        }
    if constexpr (kWeight) {  // the C fragments of dW^T hold whole sums already
#pragma unroll
        for (int n = 0; n < 2 * kMT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = 16 * m0 + 8 * n + 2 * t4 + (e & 1), tap = g + 8 * (e >> 1);
                if (tap < 9) rw[c * kOut + tap] = dw[n][e];
            }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < C * kOut; i += blockDim.x) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w * C * kOut + i];
        partial[(size_t)blockIdx.x * C * kOut + i] = s;
    }
}

// Blocks of a pass's grid (for a backward pass, the rows of its partials): for f32 (the
// FFMA kernels) B * tiles; for bf16 (the tensor-core kernels, C = 64 only) a persistent
// grid of as many blocks as fit the card at once (at most one an item). Sets the
// kernel's shared-memory limit where it needs more than 48 KB. 0 if the clip is too long.
template <typename Kernel>
int persistent_blocks(Kernel kernel, size_t smem, int items) {
    if (smem > kSmemLimit &&
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMmaSmemMax)) !=
            cudaSuccess)
        return 0;
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) != cudaSuccess || per_sm == 0)
        return 0;
    return items < per_sm * sms ? items : per_sm * sms;
}

int grid_blocks(int pass, int B, int F, int T, int C, int is_bf16) {
    if (!is_bf16) {
        const int R = rows_per_block(F, T, C);
        return R == 0 ? 0 : B * ((F / 2 + R - 1) / R);
    }
    const int R = mma_rows(F, T, pass);
    if (R == 0 || C != kMmaC) return 0;
    const size_t smem = mma_smem_bytes(R, T, pass);
    const int items = B * ((F / 2 + R - 1) / R);
    if (pass == kFwd) return persistent_blocks(block1_fwd_mma_kernel, smem, items);
    return pass == kSums ? persistent_blocks(block1_bwd_mma_kernel<false>, smem, items)
                         : persistent_blocks(block1_bwd_mma_kernel<true>, smem, items);
}

// nblk: the grid, as grid_blocks gave it
int launch_fwd(const void* x, int is_bf16, int B, int F, int T, int C, const float* params, int nblk, void* out,
               cudaStream_t stream) {
    if (!is_bf16) {
        const int R = rows_per_block(F, T, C);
        if (R == 0 || nblk != B * ((F / 2 + R - 1) / R)) return static_cast<int>(cudaErrorInvalidValue);
        block1_fwd_kernel<<<nblk, kThreads, smem_bytes(R, T, C), stream>>>(
            static_cast<const float*>(x), params, static_cast<float*>(out), F, T, C, R, (F / 2 + R - 1) / R);
    } else {
        const int R = mma_rows(F, T, kFwd);
        if (R == 0 || C != kMmaC || nblk <= 0) return static_cast<int>(cudaErrorInvalidValue);
        const int tiles = (F / 2 + R - 1) / R;
        block1_fwd_mma_kernel<<<nblk, kThreads, mma_smem_bytes(R, T, kFwd), stream>>>(
            static_cast<const __nv_bfloat16*>(x), params, static_cast<__nv_bfloat16*>(out), F, T, R, tiles, B * tiles);
    }
    return static_cast<int>(cudaGetLastError());
}

// nblk: the rows of `partial`, as grid_blocks gave them
template <bool kWeight>
int launch_bwd(const void* x, const void* dp, int is_bf16, int B, int F, int T, int C, const float* params, int nblk,
               float* partial, float* out, cudaStream_t stream) {
    if (!is_bf16) {
        const int R = rows_per_block(F, T, C);
        if (R == 0 || nblk != B * ((F / 2 + R - 1) / R)) return static_cast<int>(cudaErrorInvalidValue);
        block1_bwd_kernel<kWeight><<<nblk, kThreads, smem_bytes(R, T, C), stream>>>(
            static_cast<const float*>(x), static_cast<const float*>(dp), params, partial, F, T, C, R,
            (F / 2 + R - 1) / R);
    } else {
        const int pass = kWeight ? kDW : kSums;
        const int R = mma_rows(F, T, pass);
        if (R == 0 || C != kMmaC || nblk <= 0) return static_cast<int>(cudaErrorInvalidValue);
        const int tiles = (F / 2 + R - 1) / R;
        block1_bwd_mma_kernel<kWeight><<<nblk, kThreads, mma_smem_bytes(R, T, pass), stream>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dp), params, partial, F, T, R,
            tiles, B * tiles);
    }
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int n = C * (kWeight ? 10 : 2);
    reduce_partials_kernel<<<(n + kWarps - 1) / kWarps, kThreads, 0, stream>>>(partial, nblk, n, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The grid of a pass (0 the forward, 1 the sums pass, 2 the dW pass; for a backward
// pass also the rows of its scratch tensor of partials [rows, C, 2 or 10]) for a
// [B, 1, F, T] input on the current device; 0 if the clip is too long for the kernels'
// shared-memory tile. Not to be called while a stream is being captured (it may set a
// kernel attribute).
extern "C" int audiossl_block1_blocks(int pass, int B, int F, int T, int C, int is_bf16) {
    return pass == kFwd || pass == kSums || pass == kDW ? grid_blocks(pass, B, F, T, C, is_bf16) : 0;
}

// x [B, 1, F, T] (bf16 if is_bf16, else f32), params [C, 16] f32 ->
// out [B, C, F/2, T/2] in x's dtype. F and T even; bf16 takes C = 64 only. nblk from
// audiossl_block1_blocks(0, ...). Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int audiossl_block1_fwd(const void* x, int is_bf16, int B, int F, int T, int C, const float* params,
                                   int nblk, void* out, void* stream) {
    return launch_fwd(x, is_bf16, B, F, T, C, params, nblk, out, static_cast<cudaStream_t>(stream));
}

// x [B, 1, F, T], dp [B, C, F/2, T/2] (both bf16 or both f32), params [C, 16] ->
// out [C, 2] f32 = (sum dy, sum dy * y_raw); partial [nblk, C, 2] is scratch, nblk
// from audiossl_block1_blocks(1, ...).
extern "C" int audiossl_block1_bwd_sums(const void* x, const void* dp, int is_bf16, int B, int F, int T, int C,
                                        const float* params, int nblk, float* partial, float* out, void* stream) {
    return launch_bwd<false>(x, dp, is_bf16, B, F, T, C, params, nblk, partial, out, static_cast<cudaStream_t>(stream));
}

// As audiossl_block1_bwd_sums, -> out [C, 10] f32 = (dW[c, 0, di, dj] at di * 3 + dj, dbias);
// partial [nblk, C, 10] is scratch, nblk from audiossl_block1_blocks(2, ...).
extern "C" int audiossl_block1_bwd_weight(const void* x, const void* dp, int is_bf16, int B, int F, int T, int C,
                                          const float* params, int nblk, float* partial, float* out, void* stream) {
    return launch_bwd<true>(x, dp, is_bf16, B, F, T, C, params, nblk, partial, out, static_cast<cudaStream_t>(stream));
}
