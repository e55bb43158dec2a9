// Fused librosa log-mel on Hopper: reflect-padded wave -> [B, n_mels, n_frames].
//
// Replaces the TPU kernels audiossl_tpu/frontend/pallas_stft.py
// log_mel_fused_ct2 (_ct2_kernel, in-kernel framing, bf16x3 dots) and
// log_mel_fused_ct (_ct_kernel, framing outside the kernel): this source
// computes the same function for every n_fft % 256 == 0 and any hop: each
// frame of the padded wave windowed by the periodic Hann centred in n_fft,
// its real DFT, the power, the Slaney filterbank as sum w * (p + EPS64) over
// each filter's nonzero bins, + EPS32 and the natural log. Every operation is
// full f32 FFMA: no tensor cores, because a TF32 or one-pass bf16 product
// misses the 1e-3 librosa contract (the TPU's single-pass bf16 dot measured
// 1.7e-2, pallas_stft.py:81-86). Framing happens in the kernel: a block
// stages a tile's sample span of the wave in shared memory, and no
// [rows, n_fft] frame tensor exists in device memory.
//
// Which width takes which design:
//   * n_fft a power of two (256, 512, 1024, 2048: every config of the repo):
//     log_mel_fft_kernel. A block walks over (clip, tile of kFftFrames
//     frames) items (a grid-stride loop, so a block loads the tables once).
//     For each item it stages the tile's span, (kFftFrames - 1) * hop + n_fft
//     floats, with 16-byte cp.async copies where the span starts 16-byte
//     aligned (scalar copies otherwise); each warp then takes frames of the
//     tile in turn: it reads its frame from the span, multiplies by the
//     window, packs even and odd samples as n_fft / 2 complex points and runs
//     fft_smem.cuh's radix-4 Stockham passes and split post-pass (the
//     arithmetic of fused_rows.cu's fft_rows_kernel, with the same f32
//     twiddles computed in float64 on the host) into the power. Bins below
//     n_dense take the power from the dense arithmetic instead (an FMA chain
//     over the frame's taps against the window-folded DFT bank, which is how
//     the plain version sums them): that is where a filter passes one bin on
//     alone, as the lowest Slaney filters do at n_fft 256 with 64 mels
//     (n_dense = 32). There, near a zero of the spectrum, an f32 FFT and the
//     plain version's f32 bank round 3.6e-4 to 6.3e-4 apart (NumPy model of
//     this schedule on white noise and quiet sines), too close to the 1e-3
//     contract; with the dense bins, 2.4e-6. Filters two bins wide or wider
//     (1024 with 128 mels: 2.5e-4 on sines, as far as the plain version is
//     from float64) take the FFT's bins. The mel + log epilogue uses the
//     filters' packed nonzero weights; the tile's [n_mels, kFftFrames] output
//     goes out through shared memory, each mel row's frames as one
//     contiguous store. Eight warps a block, two blocks an SM at n_fft 1024
//     (the span, 2 n_fft floats a warp and the tables: 98 KB); wider
//     transforms take fewer warps (fft_warps).
//   * n_fft % 256 == 0 and not a power of two (768): log_mel_ct_kernel, the
//     first design, the TPU kernels' Cooley-Tukey factorization
//     (n = 128 j + m, k = N2 t + r, N2 = n_fft / 128):
//       B_r[m]      = sum_j xw[128 j + m] * W_N2^{j r}          (radix-N2 stage)
//       C_r[m]      = B_r[m] * W_n^{m r}                         (twiddle)
//       X[N2 t + r] = sum_m C_r[m] * W_128^{m t}                 (128-point DFT)
//     for residues r = 0 .. N2/2 only; the other rfft bins are conjugate
//     mirrors of equal power. Each bin k in 0 .. n_fft/2 is written exactly
//     once: directly from position (r, t) when k <= n_fft/2, or as the mirror
//     n_fft - k when 1 <= r < N2/2. One block of 128 threads per (clip, tile
//     of kFrames frames): thread m computes C_r[m] for every frame of the
//     tile (window applied on the fly), thread t computes X[N2 t + r] for
//     every frame, reading C_r as broadcast float4s and the W_128 table from
//     shared memory; power lands in shared memory by bin, and the epilogue
//     applies each filter over its nonzero range.
//
// Bound on an H100 SXM at the serving shape ([256, 15200] clips, n_fft 1024,
// hop 160, 64 mels, 24,576 frames): the function moves 15.6 MB of wave in
// and 6.3 MB of log-mel out (about 6.5 us at 3.35 TB/s) and needs about
// 0.76 GFLOP (a real 1024-point FFT is about 2.5 N log2 N = 25.6k FLOP per
// frame, plus window, power, the filterbank's 966 nonzeros and the log),
// about 11 us at the 67 TFLOP/s f32 non-tensor peak: bound by f32 operations
// at about 0.011 ms. The FFT design does about 0.83 GFLOP there
// (fused_stft.design_flops), so its arithmetic is within 1.1x of the
// function's; its Stockham passes move every point through shared memory
// five times, which is what it spends time on. The Cooley-Tukey design's
// 128-point DFTs take 513 bins x 128 complex MACs per frame, 13.7 GFLOP, at
// least 0.2 ms: 18x the bound.

#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace {

constexpr int kThreads = 128;  // Cooley-Tukey design: one thread per m in stage 1, per t in stage 2
constexpr int kFrames = 8;     // Cooley-Tukey design: frames per block
constexpr int kFftFrames = 16;  // FFT design: frames per item (tile)
constexpr int kFftMaxWarps = 8;
constexpr int kOutLd = kFftFrames + 1;  // FFT design: row stride of the output tile (odd: no bank conflicts)
constexpr int kSmemLimit = 232448;      // 227 KB per block on sm_90
constexpr int kSmemPerSm = 233472;      // 228 KB per SM, 1 KB of it reserved per block
constexpr float kEps64 = 2.220446049250313e-16f;    // np.finfo(np.float64).eps
constexpr float kEps32 = 1.1920928955078125e-07f;   // np.finfo(np.float32).eps

// Cooley-Tukey design. Shared-memory layout (floats), every section 16-byte aligned:
//   wave [span_pad] | window [n_fft] | w128 [128 x float2] | c [128 x kFrames x float2]
//   | power [kFrames x n_bins]
__host__ __device__ inline int span_padded(int n_fft, int hop) {
    return (((kFrames - 1) * hop + n_fft) + 3) & ~3;
}

__host__ __device__ inline int smem_floats(int n_fft, int hop) {
    return span_padded(n_fft, hop) + n_fft + 2 * 128 + 2 * 128 * kFrames + kFrames * (n_fft / 2 + 1);
}

// consts (floats, built by the host wrapper):
//   window [n_fft] | w2 [N2][R][2] | tw [R][128][2] | w128 [128][2] | fb [n_mels][n_bins]
// mel_range [n_mels][2]: first nonzero bin, one past the last.
__global__ void __launch_bounds__(kThreads)
log_mel_ct_kernel(const float* __restrict__ wave, int padded_len, int n_frames, int tiles,
                  int n_fft, int hop, int n_mels,
                  const float* __restrict__ consts, const int* __restrict__ mel_range,
                  float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int n2 = n_fft / 128;
    const int r_max = n2 / 2 + 1;
    const int half = n_fft / 2;
    const int n_bins = half + 1;
    const int span = (kFrames - 1) * hop + n_fft;

    const float* g_window = consts;
    const float* g_w2 = g_window + n_fft;
    const float* g_tw = g_w2 + 2 * n2 * r_max;
    const float* g_w128 = g_tw + 2 * r_max * 128;
    const float* g_fb = g_w128 + 2 * 128;

    float* s_wave = smem;
    float* s_win = s_wave + span_padded(n_fft, hop);
    float2* s_w128 = reinterpret_cast<float2*>(s_win + n_fft);
    float2* s_c = s_w128 + 128;
    float* s_pow = reinterpret_cast<float*>(s_c + 128 * kFrames);

    const int b = blockIdx.x / tiles;
    const int frame0 = (blockIdx.x % tiles) * kFrames;
    const long long start = static_cast<long long>(frame0) * hop;
    const float* src = wave + static_cast<long long>(b) * padded_len;

    for (int i = tid; i < span; i += kThreads) {
        const long long idx = start + i;
        s_wave[i] = idx < padded_len ? src[idx] : 0.0f;
    }
    for (int i = tid; i < n_fft; i += kThreads) s_win[i] = g_window[i];
    s_w128[tid] = make_float2(g_w128[2 * tid], g_w128[2 * tid + 1]);
    __syncthreads();

    for (int r = 0; r < r_max; ++r) {
        // radix-N2 stage + twiddle: thread m, every frame of the tile
        {
            const int m = tid;
            const float twc = g_tw[2 * (r * 128 + m)];
            const float tws = g_tw[2 * (r * 128 + m) + 1];
            for (int f = 0; f < kFrames; ++f) {
                const float* x = s_wave + f * hop + m;
                float br = 0.0f, bi = 0.0f;
                for (int j = 0; j < n2; ++j) {
                    const float v = x[128 * j] * s_win[128 * j + m];
                    br = fmaf(v, g_w2[2 * (j * r_max + r)], br);
                    bi = fmaf(v, g_w2[2 * (j * r_max + r) + 1], bi);
                }
                s_c[m * kFrames + f] = make_float2(br * twc - bi * tws, br * tws + bi * twc);
            }
        }
        __syncthreads();

        // 128-point DFT: thread t owns position (r, t) for every frame
        {
            const int t = tid;
            const int k = n2 * t + r;
            const bool direct = k <= half;
            const bool mirror = !direct && r >= 1 && 2 * r < n2;
            if (direct || mirror) {
                const int bin = direct ? k : n_fft - k;
                float acc_re[kFrames], acc_im[kFrames];
#pragma unroll
                for (int f = 0; f < kFrames; ++f) acc_re[f] = acc_im[f] = 0.0f;
                for (int m = 0; m < 128; ++m) {
                    const float2 w = s_w128[(m * t) & 127];
                    const float4* cp = reinterpret_cast<const float4*>(s_c + m * kFrames);
#pragma unroll
                    for (int p = 0; p < kFrames / 2; ++p) {
                        const float4 c = cp[p];  // frames 2p (x, y) and 2p + 1 (z, w)
                        acc_re[2 * p] = fmaf(c.x, w.x, fmaf(-c.y, w.y, acc_re[2 * p]));
                        acc_im[2 * p] = fmaf(c.x, w.y, fmaf(c.y, w.x, acc_im[2 * p]));
                        acc_re[2 * p + 1] = fmaf(c.z, w.x, fmaf(-c.w, w.y, acc_re[2 * p + 1]));
                        acc_im[2 * p + 1] = fmaf(c.z, w.y, fmaf(c.w, w.x, acc_im[2 * p + 1]));
                    }
                }
#pragma unroll
                for (int f = 0; f < kFrames; ++f)
                    s_pow[f * n_bins + bin] = acc_re[f] * acc_re[f] + acc_im[f] * acc_im[f];
            }
        }
        __syncthreads();
    }

    // mel + log epilogue: (mel, frame) pairs, frames fastest for the store
    for (int idx = tid; idx < n_mels * kFrames; idx += kThreads) {
        const int i = idx / kFrames;
        const int f = idx % kFrames;
        const int frame = frame0 + f;
        if (frame >= n_frames) continue;
        const int lo = mel_range[2 * i];
        const int hi = mel_range[2 * i + 1];
        const float* w = g_fb + static_cast<long long>(i) * n_bins;
        const float* p = s_pow + f * n_bins;
        float acc = 0.0f;
        for (int k = lo; k < hi; ++k) acc = fmaf(w[k], p[k] + kEps64, acc);
        out[(static_cast<long long>(b) * n_mels + i) * n_frames + frame] = logf(acc + kEps32);
    }
}

// ---------------------------------------------------------------- FFT design

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared memory of log_mel_fft_kernel (floats): twiddles [n] float2, window
// [n], packed mel weights [nnz], [n_mels][3] ints (first bin, one past the
// last, offset of the weights), the span [(kFftFrames - 1) hop + n], the
// output tile [n_mels][kOutLd], then per warp two re/im buffer pairs of n / 2
// points (2 n).
__host__ __device__ inline int fft_smem_bytes(int n, int hop, int nnz, int n_mels, int warps) {
    const long long floats = 3LL * n + round4(nnz) + round4(3 * n_mels) + round4((kFftFrames - 1) * hop + n) +
                             round4(n_mels * kOutLd) + 2LL * warps * n;
    return floats * 4 > kSmemLimit ? kSmemLimit + 1 : static_cast<int>(floats * 4);
}

// Warps per block: of 8, 4, 2 and 1, the one that keeps the most warps
// resident on an SM by shared memory (ties to more warps a block); 0 when
// even one warp does not fit.
int fft_warps(int n, int hop, int nnz, int n_mels) {
    int best = 0, best_resident = 0;
    for (int w = kFftMaxWarps; w >= 1; w /= 2) {
        const int bytes = fft_smem_bytes(n, hop, nnz, n_mels, w);
        if (bytes > kSmemLimit) continue;
        const int resident = w * (kSmemPerSm / (bytes + 1024));
        if (resident > best_resident) {
            best = w;
            best_resident = resident;
        }
    }
    return best;
}

// 16 bytes global -> shared
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__global__ void __launch_bounds__(32 * kFftMaxWarps)
log_mel_fft_kernel(const float* __restrict__ wave, int padded_len, int n_frames, int items, int tiles, int n, int hop,
                   int n_mels, int nnz, const float* __restrict__ window, const float2* __restrict__ twiddle,
                   const float* __restrict__ fbp, const int* __restrict__ mel_range, const int* __restrict__ mel_off,
                   const float* __restrict__ bank, int n_dense, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    const int m = n / 2, n_bins = m + 1;
    const int warps = blockDim.x / 32;
    const int span = (kFftFrames - 1) * hop + n;
    float2* tw = reinterpret_cast<float2*>(smem);        // [n]
    float* wn = smem + 2 * n;                             // [n]
    float* fw = wn + n;                                   // [nnz]
    int* mr = reinterpret_cast<int*>(fw + round4(nnz));  // [n_mels][3]
    float* s_span = reinterpret_cast<float*>(mr + round4(3 * n_mels));
    float* outs = s_span + round4(span);                  // [n_mels][kOutLd]
    float* work = outs + round4(n_mels * kOutLd);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        tw[i] = twiddle[i];
        wn[i] = window[i];
    }
    for (int i = threadIdx.x; i < nnz; i += blockDim.x) fw[i] = fbp[i];
    for (int i = threadIdx.x; i < n_mels; i += blockDim.x) {
        mr[3 * i] = mel_range[2 * i];
        mr[3 * i + 1] = mel_range[2 * i + 1];
        mr[3 * i + 2] = mel_off[i];
    }

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* buf0 = work + warp * 2 * n;  // re0 | im0 | re1 | im1, m floats each
    float* buf1 = buf0 + n;
    const long long ld_bank = 2LL * n_bins;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / tiles;
        const int frame0 = (item - b * tiles) * kFftFrames;
        const long long start = static_cast<long long>(frame0) * hop;
        const float* src = wave + static_cast<long long>(b) * padded_len + start;
        const long long left = padded_len - start;
        const int nvalid = left < span ? static_cast<int>(left) : span;
        __syncthreads();  // the tables are in; the previous item's span and output tile are read
        if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
            const int chunks = nvalid / 4;
            for (int c = threadIdx.x; c < chunks; c += blockDim.x) cp_async16(s_span + 4 * c, src + 4 * c);
            asm volatile("cp.async.commit_group;\n" ::);
            for (int i = 4 * chunks + threadIdx.x; i < span; i += blockDim.x) s_span[i] = i < nvalid ? src[i] : 0.0f;
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        } else {
            for (int i = threadIdx.x; i < span; i += blockDim.x) s_span[i] = i < nvalid ? src[i] : 0.0f;
        }
        __syncthreads();

        for (int f = warp; f < kFftFrames && frame0 + f < n_frames; f += warps) {
            const float* x = s_span + f * hop;
            float* re = buf0;
            float* im = buf0 + m;
            for (int i = lane; i < m; i += 32) {  // z[i] = (x[2i] w[2i], x[2i+1] w[2i+1])
                re[i] = x[2 * i] * wn[2 * i];
                im[i] = x[2 * i + 1] * wn[2 * i + 1];
            }
            __syncwarp();
            const float* sr = fft_passes(buf0, buf1, m, tw, lane);
            float* pw = sr == buf0 ? buf1 : buf0;
            split_power(sr, pw, m, n, tw, lane);
            __syncwarp();
            // bins below n_dense: an FMA chain over the taps against the window-folded bank
            for (int j = lane; j < n_dense; j += 32) {
                float cr = 0.0f, ci = 0.0f;
#pragma unroll 8
                for (int t = 0; t < n; ++t) {
                    const float xv = x[t];
                    cr = fmaf(xv, __ldg(bank + t * ld_bank + j), cr);
                    ci = fmaf(xv, __ldg(bank + t * ld_bank + n_bins + j), ci);
                }
                pw[j] = cr * cr + ci * ci;
            }
            __syncwarp();
            for (int i = lane; i < n_mels; i += 32) {
                const int lo = mr[3 * i], hi = mr[3 * i + 1];
                const float* w = fw + mr[3 * i + 2] - lo;
                float acc = 0.0f;
                for (int k = lo; k < hi; ++k) acc = fmaf(w[k], pw[k] + kEps64, acc);
                outs[i * kOutLd + f] = logf(acc + kEps32);
            }
            __syncwarp();
        }
        __syncthreads();
        for (int idx = threadIdx.x; idx < n_mels * kFftFrames; idx += blockDim.x) {
            const int i = idx / kFftFrames, f = idx - i * kFftFrames;
            const int frame = frame0 + f;
            if (frame < n_frames) out[(static_cast<long long>(b) * n_mels + i) * n_frames + frame] = outs[i * kOutLd + f];
        }
    }
}

}  // namespace

// Warps per block the FFT design takes for an n-point transform at this hop
// with nnz packed mel weights; 0 when n is not a power of two >= 8 or one
// warp's share does not fit in shared memory.
extern "C" int audiossl_log_mel_fft_warps(int n, int hop, int nnz, int n_mels) {
    if (n < 8 || (n & (n - 1)) != 0 || hop <= 0 || nnz < 0 || n_mels <= 0) return 0;
    return fft_warps(n, hop, nnz, n_mels);
}

// FFT design. wave [batch, padded_len] f32 (already reflect-padded);
// window [n] f32; twiddle [n, 2] f32 (W_n^e = cos, -sin of 2 pi e / n); fbp
// [nnz] f32, each filter's weights over its nonzero bins, filter after
// filter; mel_range [n_mels, 2] int32 (first nonzero bin, one past the
// last); mel_off [n_mels] int32, where filter i's weights start in fbp; bank
// [n, n + 2] f32, the window-folded real DFT (cos columns, then sin), read
// for the bins below n_dense only; out [batch, n_mels, n_frames] f32.
// Returns cudaGetLastError() after the launch (0 on success). Launches on
// `stream`; allocates nothing and does not synchronise.
extern "C" int audiossl_log_mel_fft(const float* wave, int batch, int padded_len, int n_frames, int n, int hop,
                                    int n_mels, int nnz, const float* window, const float* twiddle, const float* fbp,
                                    const int* mel_range, const int* mel_off, const float* bank, int n_dense,
                                    float* out, void* stream) {
    if (batch <= 0 || n_frames <= 0 || n_dense < 0 || n_dense > n / 2 + 1 || (n_dense > 0 && !bank) ||
        static_cast<long long>(n_frames - 1) * hop + n > padded_len)
        return static_cast<int>(cudaErrorInvalidValue);
    const int warps = audiossl_log_mel_fft_warps(n, hop, nnz, n_mels);
    if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = fft_smem_bytes(n, hop, nnz, n_mels, warps);
    cudaError_t err = cudaFuncSetAttribute(log_mel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, log_mel_fft_kernel, 32 * warps, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (n_frames + kFftFrames - 1) / kFftFrames;
    const long long items = static_cast<long long>(batch) * tiles;
    if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int blocks = static_cast<int>(items < resident ? items : resident);
    log_mel_fft_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
        wave, padded_len, n_frames, static_cast<int>(items), tiles, n, hop, n_mels, nnz, window,
        reinterpret_cast<const float2*>(twiddle), fbp, mel_range, mel_off, bank, n_dense, out);
    return static_cast<int>(cudaGetLastError());
}

// Cooley-Tukey design (any n_fft % 256 == 0; the wrapper sends it the widths
// that are not a power of two). consts and mel_range as built by
// fused_stft.ct_constants. Same launch contract as audiossl_log_mel_fft.
extern "C" int audiossl_log_mel_ct(const float* wave, int batch, int padded_len, int n_frames,
                                int n_fft, int hop, int n_mels, const float* consts,
                                const int* mel_range, float* out, void* stream) {
    if (batch <= 0 || n_frames <= 0 || n_fft % 256 != 0 || hop <= 0 || n_mels <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = static_cast<int>(sizeof(float)) * smem_floats(n_fft, hop);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            log_mel_ct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int tiles = (n_frames + kFrames - 1) / kFrames;
    log_mel_ct_kernel<<<batch * tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        wave, padded_len, n_frames, tiles, n_fft, hop, n_mels, consts, mel_range, out);
    return static_cast<int>(cudaGetLastError());
}
