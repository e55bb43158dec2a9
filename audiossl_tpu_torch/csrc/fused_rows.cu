// Spectrogram rows on Hopper: frame rows -> window -> zero-pad to N ->
// |real DFT|^2 -> mel over each filter's nonzero bins -> log, in one of three
// modes (the launch's `mode`: kModeKaldi, kModeLibrosa, kModeKaldiMagnitude).
//
// Replaces the TPU kernel audiossl_tpu/frontend/pallas_stft.py _fused_rows
// (pallas_call at :137, body _kernel at :80), which two functions reach:
//   kaldi_fbank_fused (:533), log mode "kaldi":   log(max(mel(power), EPS32)),
//     rows of 400 samples after DC removal and preemphasis, the symmetric
//     Hanning window, zero-padded to a 512-point real DFT, Kaldi mel banks
//     with the Nyquist column; with use_power=False (kModeKaldiMagnitude)
//     the magnitude sqrt(power) goes into the mel product, as the plain
//     kaldi_fbank does (audiossl_tpu/frontend/fbank.py:118-119; the TPU
//     kernel ignores the flag and always takes the power);
//   log_mel_fused (:99), log mode "librosa": log(mel(power + EPS64) + EPS32),
//     rows of n_fft samples, the periodic Hann (centred in n_fft).
// Framing, DC removal and preemphasis run in plain torch before the kernel,
// as kaldi_fbank_fused does (pallas_stft.py:551-558); the kernel reads the
// [rows, win] frame matrix.
//
// Every operation is full f32 FFMA: a TF32 or one-pass bf16 product misses
// the 1e-3 contract (the TPU's one-pass bf16 dot measured 1.7e-2 on the
// log-mel, pallas_stft.py:81-86).
//
// Bound on an H100 SXM at the SS-MAST shape (64 clips x 998 frames = 63,872
// rows of 400 samples, 128 mels): the function reads 102.2 MB of frames and
// writes 32.7 MB (0.040 ms at 3.35 TB/s) and needs about 0.9 GFLOP (a real
// 512-point FFT at 2.5 N log2 N per frame plus window, power and the mel
// nonzeros), 0.013 ms at 67 TFLOP/s f32: bound by bytes. The first design,
// a dense window-folded DFT (2 x 400 x 514 FMA a row, 26.3 GFLOP, two
// L2 loads of bank values per tap), took 26x that bound.
//
// Which width takes which design:
//   * N a power of two (N >= 8), every config of the repo (Kaldi 400 -> 512,
//     librosa n_fft 1024): fft_rows_kernel. A warp takes whole rows, in turn
//     (a grid-stride loop; a block loads the constants once). It reads its
//     row coalesced (16 bytes a thread where win % 4 == 0), multiplies by the
//     window and packs the even/odd samples as the M = N/2 complex points
//     z[i] = x[2i] + i x[2i+1], zero past the row. An M-point complex FFT
//     runs as radix-4 Stockham passes (a radix-2 pass last where log2 M is
//     odd) between two re/im buffers of the warp's shared memory, separated
//     by __syncwarp only. The split post-pass gives X[k] = E[k] + W_N^k O[k]
//     for k = 0..M, E = (Z[k] + conj Z[M-k]) / 2, O = (Z[k] - conj Z[M-k]) / 2i,
//     and the power (the passes and the post-pass are fft_smem.cuh's, which
//     log_mel.cu shares). Bins below n_dense take the power of the dense
//     design's arithmetic instead (low_bins_kernel, one more launch before
//     the FFT kernel, into a [rows, n_dense] scratch):
//     a filter over one bin passes that bin's power on alone, and near a
//     zero of the spectrum, or in the notch that DC removal and preemphasis
//     cut below bin 3, f32 rounding moves its log by more than the 1e-3
//     contract whichever way the bin is summed. On SS-MAST's rows of white
//     noise (64 clips, NumPy) an f32 FFT alone lands 2.0e-3 from a float64
//     reference and the window-folded f32 bank 1.2e-3 from it, in other
//     directions; with the bins of Kaldi's single-bin filters (below 24,
//     n_dense = 32) from the bank, as the reference sums them, the kernel
//     lands 2.1e-5 from the plain version. librosa's Slaney filters are
//     all 4 bins or wider at n_fft 1024: n_dense = 0. Each lane then
//     sums its mels over their nonzero bins
//     (weights packed in shared memory), takes the log and writes the row.
//     Twiddles W_N^e = (cos, -sin)(2 pi e / N) are computed in float64 on
//     the host and stored as f32, as in log_mel.cu. The FFT kernel reads the
//     frames once and writes the outputs once; low_bins_kernel (Kaldi)
//     reads the frames once more and writes 32 floats a row.
//   * Any other width (a librosa n_fft such as 400): dense_rows_kernel, the
//     first design. One block per tile of R frame rows (R = 32, 16 or 8,
//     whichever fits in shared memory) staged transposed ([win][R + 4]);
//     thread j computes bin j of all R rows against the window-folded DFT
//     bank (2R FMAs per tap), power lands in shared memory and the epilogue
//     applies each mel filter over its nonzero range.

#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace {

constexpr float kEps64 = 2.220446049250313e-16f;    // np.finfo(np.float64).eps
constexpr float kEps32 = 1.1920928955078125e-07f;   // np.finfo(np.float32).eps
constexpr int kModeKaldi = 0;                        // log(max(mel(power), EPS32))
constexpr int kModeLibrosa = 1;                      // log(mel(power + EPS64) + EPS32)
constexpr int kModeKaldiMagnitude = 2;               // log(max(mel(sqrt(power)), EPS32))
constexpr int kMaxThreads = 544;                     // 17 warps: one thread per bin up to 544 bins
constexpr int kSmemLimit = 232448;                   // 227 KB per block on sm_90
constexpr int kFftWarps = 8;                         // rows in flight per block of the FFT kernel
constexpr int kLowWarps = 4;                         // low_bins_kernel: warps per block
constexpr int kLowRows = 32;                         // low_bins_kernel: rows per block, 8 a warp
constexpr int kLowUnroll = 8;                        // low_bins_kernel: taps whose bank values load together

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared memory of fft_rows_kernel: twiddles [n] float2, window, packed mel
// weights, [n_mels][3] ints (first bin, one past the last, offset of the
// weights), then per warp two re/im buffer pairs of n / 2 points (4 x n / 2).
__host__ __device__ inline int fft_smem_bytes(int win, int n, int nnz, int n_mels, int warps) {
    return 4 * (2 * n + round4(win) + round4(nnz) + round4(3 * n_mels) + warps * 2 * n);
}

__global__ void __launch_bounds__(32 * kFftWarps)
fft_rows_kernel(const float* __restrict__ frames, int rows, int win, int n, int n_mels, int nnz, int vec,
                const float* __restrict__ window, const float2* __restrict__ twiddle, const float* __restrict__ fbp,
                const int* __restrict__ mel_range, const int* __restrict__ mel_off, int mode, int n_dense,
                const float* __restrict__ dense_pw, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    const int m = n / 2;
    const int warps = blockDim.x / 32;
    float2* tw = reinterpret_cast<float2*>(smem);  // [n]
    float* wn = smem + 2 * n;                      // [win]
    float* fw = wn + round4(win);                  // [nnz]
    int* mr = reinterpret_cast<int*>(fw + round4(nnz));  // [n_mels][3]
    float* work = reinterpret_cast<float*>(mr + round4(3 * n_mels));
    for (int i = threadIdx.x; i < n; i += blockDim.x) tw[i] = twiddle[i];
    for (int i = threadIdx.x; i < win; i += blockDim.x) wn[i] = window[i];
    for (int i = threadIdx.x; i < nnz; i += blockDim.x) fw[i] = fbp[i];
    for (int i = threadIdx.x; i < n_mels; i += blockDim.x) {
        mr[3 * i] = mel_range[2 * i];
        mr[3 * i + 1] = mel_range[2 * i + 1];
        mr[3 * i + 2] = mel_off[i];
    }
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* buf0 = work + warp * 2 * n;  // re0 | im0 | re1 | im1, m floats each
    float* buf1 = buf0 + n;
    for (long long row = static_cast<long long>(blockIdx.x) * warps + warp; row < rows;
         row += static_cast<long long>(gridDim.x) * warps) {
        const float* src = frames + row * win;
        float* re = buf0;
        float* im = buf0 + m;
        if (vec) {  // z[2p] = (x0 w0, x1 w1), z[2p + 1] = (x2 w2, x3 w3); zeros past the row
            const float4* s4 = reinterpret_cast<const float4*>(src);
            for (int p = lane; p < win / 4; p += 32) {
                const float4 x = __ldg(s4 + p);
                re[2 * p] = x.x * wn[4 * p];
                im[2 * p] = x.y * wn[4 * p + 1];
                re[2 * p + 1] = x.z * wn[4 * p + 2];
                im[2 * p + 1] = x.w * wn[4 * p + 3];
            }
            for (int i = win / 2 + lane; i < m; i += 32) re[i] = im[i] = 0.0f;
        } else {
            for (int i = lane; i < n; i += 32) {
                const float v = i < win ? src[i] * wn[i] : 0.0f;
                ((i & 1) ? im : re)[i >> 1] = v;
            }
        }
        __syncwarp();
        const float* sr = fft_passes(buf0, buf1, m, tw, lane);
        float* pw = sr == buf0 ? buf1 : buf0;
        split_power(sr, pw, m, n, tw, lane);
        __syncwarp();
        // the first n_dense bins: the power the dense kernel wrote for this row
        for (int k = lane; k < n_dense; k += 32) pw[k] = dense_pw[row * n_dense + k];
        __syncwarp();
        for (int i = lane; i < n_mels; i += 32) {
            const int lo = mr[3 * i], hi = mr[3 * i + 1];
            const float* w = fw + mr[3 * i + 2] - lo;
            float acc = 0.0f;
            float v;
            if (mode == kModeLibrosa) {
                for (int k = lo; k < hi; ++k) acc = fmaf(w[k], pw[k] + kEps64, acc);
                v = logf(acc + kEps32);
            } else if (mode == kModeKaldiMagnitude) {
                for (int k = lo; k < hi; ++k) acc = fmaf(w[k], sqrtf(pw[k]), acc);
                v = logf(fmaxf(acc, kEps32));
            } else {
                for (int k = lo; k < hi; ++k) acc = fmaf(w[k], pw[k], acc);
                v = logf(fmaxf(acc, kEps32));
            }
            out[row * n_mels + i] = v;
        }
        __syncwarp();
    }
}

template <int R>
__host__ __device__ inline int smem_bytes(int win, int n_bins) {
    return static_cast<int>(sizeof(float)) * (win * (R + 4) + R * n_bins);
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
dense_rows_kernel(const float* __restrict__ frames, int rows, int win, int n_bins, int n_mels,
                  const float* __restrict__ bank, const float* __restrict__ fb,
                  const int* __restrict__ mel_range, int mode, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    constexpr int ld = R + 4;
    float* xt = smem;              // [win][ld]: the tile's rows, transposed
    float* pw = smem + win * ld;   // [R][n_bins]: power
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const long long row0 = static_cast<long long>(blockIdx.x) * R;

    for (int idx = tid; idx < R * win; idx += nt) {
        const int r = idx / win;
        const int k = idx - r * win;
        const long long row = row0 + r;
        xt[k * ld + r] = row < rows ? frames[row * win + k] : 0.0f;
    }
    __syncthreads();

    const long long ld_bank = 2LL * n_bins;
    for (int j = tid; j < n_bins; j += nt) {
        float re[R], im[R];
#pragma unroll
        for (int r = 0; r < R; ++r) re[r] = im[r] = 0.0f;
        const float* bc = bank + j;
        const float* bs = bank + n_bins + j;
        for (int k = 0; k < win; ++k) {
            const float c = __ldg(bc + k * ld_bank);
            const float s = __ldg(bs + k * ld_bank);
            const float4* xp = reinterpret_cast<const float4*>(xt + k * ld);
#pragma unroll
            for (int p = 0; p < R / 4; ++p) {
                const float4 x = xp[p];
                re[4 * p] = fmaf(x.x, c, re[4 * p]);
                im[4 * p] = fmaf(x.x, s, im[4 * p]);
                re[4 * p + 1] = fmaf(x.y, c, re[4 * p + 1]);
                im[4 * p + 1] = fmaf(x.y, s, im[4 * p + 1]);
                re[4 * p + 2] = fmaf(x.z, c, re[4 * p + 2]);
                im[4 * p + 2] = fmaf(x.z, s, im[4 * p + 2]);
                re[4 * p + 3] = fmaf(x.w, c, re[4 * p + 3]);
                im[4 * p + 3] = fmaf(x.w, s, im[4 * p + 3]);
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) pw[r * n_bins + j] = re[r] * re[r] + im[r] * im[r];
    }
    __syncthreads();

    for (int idx = tid; idx < R * n_mels; idx += nt) {
        const int r = idx / n_mels;
        const int i = idx - r * n_mels;
        const long long row = row0 + r;
        if (row >= rows) continue;
        const int lo = mel_range[2 * i];
        const int hi = mel_range[2 * i + 1];
        const float* w = fb + static_cast<long long>(i) * n_bins;
        const float* p = pw + r * n_bins;
        float acc = 0.0f;
        if (mode == kModeLibrosa) {
            for (int k = lo; k < hi; ++k) acc = fmaf(w[k], p[k] + kEps64, acc);
            out[row * n_mels + i] = logf(acc + kEps32);
        } else if (mode == kModeKaldiMagnitude) {
            for (int k = lo; k < hi; ++k) acc = fmaf(w[k], sqrtf(p[k]), acc);
            out[row * n_mels + i] = logf(fmaxf(acc, kEps32));
        } else {
            for (int k = lo; k < hi; ++k) acc = fmaf(w[k], p[k], acc);
            out[row * n_mels + i] = logf(fmaxf(acc, kEps32));
        }
    }
}

template <int R>
int dense_launch(const float* frames, int rows, int win, int n_bins, int n_mels, const float* bank,
           const float* fb, const int* mel_range, int mode, float* out, cudaStream_t stream) {
    const int smem = smem_bytes<R>(win, n_bins);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            dense_rows_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    int threads = (n_bins + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const int blocks = (rows + R - 1) / R;
    dense_rows_kernel<R><<<blocks, threads, smem, stream>>>(
        frames, rows, win, n_bins, n_mels, bank, fb, mel_range, mode, out);
    return static_cast<int>(cudaGetLastError());
}

// 16 bytes global -> shared, zero-filled where `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

// The power of bins 0 .. n_dense - 1 of every row into pw_out [rows,
// n_dense], with the dense design's arithmetic (an FMA chain over the taps
// against the window-folded bank, as the plain version's product sums it).
// A block stages kLowRows rows in shared memory with cp.async (all copies
// in flight at once); lane j takes bin j and warp w rows RT w .. RT w + RT - 1,
// so each pair of bank values a lane loads feeds 2 RT FMAs, and the bank
// values of kLowUnroll taps load together.
__global__ void __launch_bounds__(32 * kLowWarps)
low_bins_kernel(const float* __restrict__ frames, int rows, int win, int n_bins, const float* __restrict__ bank,
                int n_dense, int vec, float* __restrict__ pw_out) {
    extern __shared__ __align__(16) float smem[];
    constexpr int R = kLowRows, RT = R / kLowWarps;
    const int ldx = round4(win);
    float* xs = smem;  // [R][ldx], row-major
    const long long row0 = static_cast<long long>(blockIdx.x) * R;
    const int nr = rows - row0 < R ? static_cast<int>(rows - row0) : R;
    if (vec) {
        const int chunks = win / 4;
        for (int idx = threadIdx.x; idx < R * chunks; idx += blockDim.x) {
            const int r = idx / chunks, q = idx - r * chunks;
            const bool valid = r < nr;
            cp_async16(xs + r * ldx + 4 * q, valid ? frames + (row0 + r) * win + 4 * q : frames, valid);
        }
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    } else {
        for (int idx = threadIdx.x; idx < R * win; idx += blockDim.x) {
            const int r = idx / win, k = idx - r * win;
            xs[r * ldx + k] = r < nr ? frames[(row0 + r) * win + k] : 0.0f;
        }
    }
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const float* xw = xs + warp * RT * ldx;
    const long long ld_bank = 2LL * n_bins;
    for (int j = lane; j < n_dense; j += 32) {
        float re[RT], im[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) re[r] = im[r] = 0.0f;
        auto tap = [&](int k, float c, float sn) {  // re[r] += x[r][k] c, im[r] += x[r][k] sn
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const float x = xw[r * ldx + k];
                re[r] = fmaf(x, c, re[r]);
                im[r] = fmaf(x, sn, im[r]);
            }
        };
        int k = 0;
        for (; k + kLowUnroll <= win; k += kLowUnroll) {
            float c[kLowUnroll], sn[kLowUnroll];
#pragma unroll
            for (int u = 0; u < kLowUnroll; ++u) {
                c[u] = __ldg(bank + (k + u) * ld_bank + j);
                sn[u] = __ldg(bank + (k + u) * ld_bank + n_bins + j);
            }
#pragma unroll
            for (int u = 0; u < kLowUnroll; ++u) tap(k + u, c[u], sn[u]);
        }
        for (; k < win; ++k) tap(k, __ldg(bank + k * ld_bank + j), __ldg(bank + k * ld_bank + n_bins + j));
#pragma unroll
        for (int r = 0; r < RT; ++r)
            if (r + warp * RT < nr) pw_out[(row0 + warp * RT + r) * n_dense + j] = re[r] * re[r] + im[r] * im[r];
    }
}

int low_bins_launch(const float* frames, int rows, int win, int n_bins, const float* bank, int n_dense, int vec,
                    float* pw_out, cudaStream_t stream) {
    const int smem = 4 * kLowRows * round4(win);
    if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(low_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    low_bins_kernel<<<(rows + kLowRows - 1) / kLowRows, 32 * kLowWarps, smem, stream>>>(
        frames, rows, win, n_bins, bank, n_dense, vec, pw_out);
    return static_cast<int>(cudaGetLastError());
}

int fft_warps(int win, int n, int nnz, int n_mels) {
    for (int w = kFftWarps; w >= 1; w /= 2)
        if (fft_smem_bytes(win, n, nnz, n_mels, w) <= kSmemLimit) return w;
    return 0;
}

}  // namespace

// Rows per block the dense kernel takes for this width and bin count: 32,
// 16 or 8, or 0 when even 8 rows do not fit in shared memory.
extern "C" int audiossl_fused_rows_tile(int win, int n_bins) {
    if (smem_bytes<32>(win, n_bins) <= kSmemLimit) return 32;
    if (smem_bytes<16>(win, n_bins) <= kSmemLimit) return 16;
    if (smem_bytes<8>(win, n_bins) <= kSmemLimit) return 8;
    return 0;
}

// Rows in flight per block (warps) the FFT kernel takes for rows of `win`
// samples, an n-point transform and nnz packed mel weights; 0 when n is not
// a power of two >= 8, is shorter than win, or one warp's buffers do not fit.
extern "C" int audiossl_fused_rows_fft_warps(int win, int n, int nnz, int n_mels) {
    if (n < 8 || (n & (n - 1)) != 0 || win > n || win <= 0) return 0;
    return fft_warps(win, n, nnz, n_mels);
}

// Dense design. frames [rows, win] f32; bank [win, 2 * n_bins] f32 (cos
// columns, then sin); fb [n_mels, n_bins] f32; mel_range [n_mels, 2] int32
// (first nonzero bin, one past the last); out [rows, n_mels] f32. mode:
// kModeKaldi (0), kModeLibrosa (1) or kModeKaldiMagnitude (2). Returns cudaGetLastError()
// after the launch (0 on success); launches on `stream`, allocates nothing
// and does not synchronise.
extern "C" int audiossl_fused_rows(const float* frames, int rows, int win, int n_bins, int n_mels,
                                   const float* bank, const float* fb, const int* mel_range,
                                   int mode, float* out, void* stream) {
    if (rows <= 0 || win <= 0 || n_bins <= 0 || n_mels <= 0 || mode < kModeKaldi || mode > kModeKaldiMagnitude)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (audiossl_fused_rows_tile(win, n_bins)) {
        case 32: return dense_launch<32>(frames, rows, win, n_bins, n_mels, bank, fb, mel_range, mode, out, s);
        case 16: return dense_launch<16>(frames, rows, win, n_bins, n_mels, bank, fb, mel_range, mode, out, s);
        case 8: return dense_launch<8>(frames, rows, win, n_bins, n_mels, bank, fb, mel_range, mode, out, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// FFT design. frames [rows, win] f32; window [win] f32; twiddle [n, 2] f32
// (W_n^e = cos, -sin of 2 pi e / n); fbp [nnz] f32, each filter's weights
// over its nonzero bins, filter after filter; mel_range [n_mels, 2] int32;
// mel_off [n_mels] int32, where filter i's weights start in fbp; out
// [rows, n_mels] f32. With n_dense > 0 low_bins_kernel first
// writes the power of bins 0 .. n_dense - 1 from bank [win, n + 2] (as in
// audiossl_fused_rows) into dense_pw [rows, n_dense] f32 scratch, which the
// FFT kernel takes for those bins. Same launch contract as
// audiossl_fused_rows.
extern "C" int audiossl_fused_rows_fft(const float* frames, int rows, int win, int n, int n_mels, int nnz,
                                       const float* window, const float* twiddle, const float* fbp,
                                       const int* mel_range, const int* mel_off, int mode, const float* bank,
                                       int n_dense, float* dense_pw, float* out, void* stream) {
    if (rows <= 0 || n_mels <= 0 || nnz < 0 || n_dense < 0 || n_dense > n / 2 + 1 || (n_dense > 0 && !dense_pw) ||
        mode < kModeKaldi || mode > kModeKaldiMagnitude)
        return static_cast<int>(cudaErrorInvalidValue);
    const int warps = audiossl_fused_rows_fft_warps(win, n, nnz, n_mels);
    if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = fft_smem_bytes(win, n, nnz, n_mels, warps);
    cudaError_t err = cudaFuncSetAttribute(fft_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fft_rows_kernel, 32 * warps, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long groups = (static_cast<long long>(rows) + warps - 1) / warps;
    const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int blocks = static_cast<int>(groups < resident ? groups : resident);
    const int vec = (win % 4 == 0) && (reinterpret_cast<unsigned long long>(frames) % 16 == 0);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_dense > 0) {
        const int e = low_bins_launch(frames, rows, win, n / 2 + 1, bank, n_dense, vec, dense_pw, s);
        if (e) return e;
    }
    fft_rows_kernel<<<blocks, 32 * warps, smem, s>>>(
        frames, rows, win, n, n_mels, nnz, vec, window, reinterpret_cast<const float2*>(twiddle), fbp, mel_range,
        mel_off, mode, n_dense, dense_pw, out);
    return static_cast<int>(cudaGetLastError());
}
