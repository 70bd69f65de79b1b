// Native host-side frame ops for the vsr_tpu_torch pipeline (the per-pixel
// arithmetic is vsr_tpu/native/vsr_host_ops.cpp's, so the two packages paste
// identically).
//
// The reference gets its host image ops from OpenCV's C++ (resize, blend);
// our hot loop spends its host time in paste-back: upscale the 640x120
// inpainted band to the video width and blend it into the frame under the
// mask (backend/inpaint/sttn_auto_inpaint.py:312-315 semantics). Doing that
// as two cv2 calls costs two full-band passes plus a temporary; this fuses
// bilinear upsample + masked blend into one pass and writes straight into
// the frame buffer. ProPainter's band path works at native size: a plain
// crop of each band and a one-pass compose of each output frame.
//
// Bilinear sampling matches cv2.resize(INTER_LINEAR) geometry (half-pixel
// centers, edge clamp) with float weights; outputs may differ from OpenCV's
// fixed-point path by at most 1 LSB (tested).
//
// Parallel work runs on one persistent pool: min(8, cores) workers, the
// calling thread included, made on first use and asleep between jobs. Items
// are handed out through an atomic counter, so a worker that finishes early
// takes the next one. The per-frame ops hand out band rows; the batch ops
// (one call per chunk) hand out whole frames. One job runs at a time; a
// forked child makes a pool of its own on first use.
//
// Exposed as a C ABI for ctypes; built by g++ at first use into
// vsr_tpu_torch/build/ (vsr_tpu_torch/native/__init__.py).

#include <pthread.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct LerpIndex {
  int i0, i1;
  float w;
};

static void build_axis(int in_size, int out_size, std::vector<LerpIndex>& out) {
  out.resize(out_size);
  const float scale = static_cast<float>(in_size) / out_size;
  for (int i = 0; i < out_size; ++i) {
    float src = (i + 0.5f) * scale - 0.5f;
    int i0 = static_cast<int>(std::floor(src));
    float w = src - i0;
    int i1 = i0 + 1;
    if (i0 < 0) { i0 = 0; i1 = 0; w = 0.f; }
    if (i1 >= in_size) { i1 = in_size - 1; if (i0 >= in_size) i0 = in_size - 1; }
    out[i] = {i0, i1, w};
  }
}

// The persistent pool. `size` workers: size - 1 threads and the caller.
class Pool {
 public:
  explicit Pool(int size) : size_(size) {
    for (int t = 1; t < size; ++t) threads_.emplace_back([this, t] { serve(t); });
  }

  // Runs fn(i) for every i in [0, n) on at most `width` workers, the caller
  // among them; returns how many took part.
  int run(int n, int width, const std::function<void(int)>& fn) {
    width = std::min({width, size_, n});
    if (width <= 1) {
      for (int i = 0; i < n; ++i) fn(i);
      return n > 0 ? 1 : 0;
    }
    std::lock_guard<std::mutex> one_job(job_mu_);
    {
      std::lock_guard<std::mutex> lk(mu_);
      fn_ = &fn;
      n_ = n;
      helpers_ = width - 1;
      busy_ = width - 1;
      next_.store(0, std::memory_order_relaxed);
      ++generation_;
    }
    wake_.notify_all();
    take_items();
    std::unique_lock<std::mutex> lk(mu_);
    done_.wait(lk, [this] { return busy_ == 0; });
    fn_ = nullptr;
    return width;
  }

 private:
  void take_items() {
    for (int i = next_.fetch_add(1); i < n_; i = next_.fetch_add(1)) (*fn_)(i);
  }

  // Worker t sleeps until a job wants t or more helpers; a job ends only
  // after each of its helpers has checked in, so none misses one.
  void serve(int t) {
    unsigned long seen = 0;
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      wake_.wait(lk, [&] { return generation_ != seen; });
      seen = generation_;
      if (t > helpers_) continue;
      lk.unlock();
      take_items();
      lk.lock();
      if (--busy_ == 0) done_.notify_one();
    }
  }

  const int size_;
  std::vector<std::thread> threads_;
  std::mutex job_mu_;  // one job at a time, whichever thread calls
  std::mutex mu_;
  std::condition_variable wake_, done_;
  unsigned long generation_ = 0;
  int helpers_ = 0, busy_ = 0, n_ = 0;
  const std::function<void(int)>* fn_ = nullptr;
  std::atomic<int> next_{0};
};

std::mutex g_pool_mu;
Pool* g_pool = nullptr;  // never freed: its threads live as long as the process

// A forked child has none of the parent's threads: it drops the copied pool
// (whose locks may be held) and makes its own on first use.
void before_fork() { g_pool_mu.lock(); }
void after_fork_parent() { g_pool_mu.unlock(); }
void after_fork_child() {
  g_pool = nullptr;
  g_pool_mu.unlock();
}

Pool& pool() {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  if (g_pool == nullptr) {
    static bool registered = false;
    if (!registered) {
      pthread_atfork(before_fork, after_fork_parent, after_fork_child);
      registered = true;
    }
    const int cores = static_cast<int>(std::thread::hardware_concurrency());
    g_pool = new Pool(std::max(1, std::min(8, cores)));
  }
  return *g_pool;
}

// fn(i) for i in [0, n) on at most n_threads pool workers; returns how many
// took part. A job one worker wide runs on the caller and needs no pool.
static int run_items(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return n > 0 ? 1 : 0;
  }
  return pool().run(n, n_threads, fn);
}

// Band row y of a paste: the composite's rows i0 and i1 (row0, row1)
// resized along x and blended into dst under mrow.
static void paste_row(uint8_t* dst, const uint8_t* row0, const uint8_t* row1,
                      float wy, const std::vector<LerpIndex>& xs,
                      const uint8_t* mrow, int band_w) {
  for (int x = 0; x < band_w; ++x) {
    if (!mrow[x]) continue;
    const LerpIndex lx = xs[x];
    const float wx = lx.w;
    const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
    const float w10 = wy * (1 - wx), w11 = wy * wx;
    const uint8_t* p00 = row0 + lx.i0 * 3;
    const uint8_t* p01 = row0 + lx.i1 * 3;
    const uint8_t* p10 = row1 + lx.i0 * 3;
    const uint8_t* p11 = row1 + lx.i1 * 3;
    uint8_t* d = dst + x * 3;
    for (int c = 0; c < 3; ++c) {
      const float v = w00 * p00[c] + w01 * p01[c]
                    + w10 * p10[c] + w11 * p11[c];
      d[c] = static_cast<uint8_t>(v + 0.5f);
    }
  }
}

// Output row y of a resize: the source's rows row0 and row1 resized along x.
static void resize_row(uint8_t* dst, const uint8_t* row0, const uint8_t* row1,
                       float wy, const std::vector<LerpIndex>& xs, int out_w) {
  for (int x = 0; x < out_w; ++x) {
    const LerpIndex lx = xs[x];
    const float wx = lx.w;
    const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
    const float w10 = wy * (1 - wx), w11 = wy * wx;
    const uint8_t* p00 = row0 + lx.i0 * 3;
    const uint8_t* p01 = row0 + lx.i1 * 3;
    const uint8_t* p10 = row1 + lx.i0 * 3;
    const uint8_t* p11 = row1 + lx.i1 * 3;
    uint8_t* d = dst + x * 3;
    for (int c = 0; c < 3; ++c) {
      const float v = w00 * p00[c] + w01 * p01[c]
                    + w10 * p10[c] + w11 * p11[c];
      d[c] = static_cast<uint8_t>(v + 0.5f);
    }
  }
}

// One paste's geometry: the composite holds model rows [r0, r1) of a
// comp_h-row band (rows outside read as zeros), resized to band_h x band_w
// and blended into frame rows [y0, y0 + band_h) under mask01.
struct PasteGeometry {
  int frame_w, r0, r1, comp_w, y0, band_w;
  const uint8_t* mask01;
  std::vector<LerpIndex> ys, xs;
  std::vector<uint8_t> zeros;

  PasteGeometry(int frame_w, int r0, int r1, int comp_h, int comp_w,
                const uint8_t* mask01, int y0, int band_h, int band_w)
      : frame_w(frame_w), r0(r0), r1(r1), comp_w(comp_w), y0(y0),
        band_w(band_w), mask01(mask01), zeros(static_cast<size_t>(comp_w) * 3, 0) {
    build_axis(comp_h, band_h, ys);
    build_axis(comp_w, band_w, xs);
  }

  const uint8_t* comp_row(const uint8_t* comp, int i) const {
    if (i < r0 || i >= r1) return zeros.data();
    return comp + static_cast<size_t>(i - r0) * comp_w * 3;
  }

  void paste(uint8_t* frame, const uint8_t* comp, int y) const {
    const LerpIndex ly = ys[y];
    paste_row(frame + (static_cast<size_t>(y0 + y) * frame_w) * 3,
              comp_row(comp, ly.i0), comp_row(comp, ly.i1), ly.w, xs,
              mask01 + static_cast<size_t>(y) * band_w, band_w);
  }
};

// One crop's geometry: frame rows [y0, y0 + crop_h) (crop_w wide) resized
// to out_h x out_w.
struct CropGeometry {
  int frame_w, y0, out_w;
  std::vector<LerpIndex> ys, xs;

  CropGeometry(int frame_w, int y0, int crop_h, int crop_w, int out_h, int out_w)
      : frame_w(frame_w), y0(y0), out_w(out_w) {
    build_axis(crop_h, out_h, ys);
    build_axis(crop_w, out_w, xs);
  }

  void resize(const uint8_t* frame, uint8_t* out, int y) const {
    const uint8_t* base = frame + static_cast<size_t>(y0) * frame_w * 3;
    const LerpIndex ly = ys[y];
    resize_row(out + static_cast<size_t>(y) * out_w * 3,
               base + static_cast<size_t>(ly.i0) * frame_w * 3,
               base + static_cast<size_t>(ly.i1) * frame_w * 3, ly.w, xs, out_w);
  }
};

}  // namespace

extern "C" {

// Fused: comp (comp_h x comp_w x 3, uint8) bilinear-resized to
// (band_h x band_w) and blended into frame rows [y0, y0+band_h) under
// mask01 (band_h x band_w, uint8 {0,1}):
//   frame = mask * resized + (1 - mask) * frame
// frame: full image (frame_w x frame_h x 3), row stride frame_w*3. Band
// rows are spread over at most n_threads pool workers.
void paste_band_blend(uint8_t* frame, int frame_w,
                      const uint8_t* comp, int comp_h, int comp_w,
                      const uint8_t* mask01,
                      int y0, int band_h, int band_w,
                      int n_threads) {
  const PasteGeometry g(frame_w, 0, comp_h, comp_h, comp_w, mask01, y0, band_h, band_w);
  run_items(band_h, n_threads, [&](int y) { g.paste(frame, comp, y); });
}

// paste_band_blend over a chunk: comps (n x comp_rows x comp_w x 3) hold
// model rows [r0, r0 + comp_rows) of each comp_h-row composite, the rest of
// which reads as zeros; comps[j] goes into frames[j]. Whole frames are
// spread over at most n_threads pool workers; returns how many took part.
int paste_band_blend_batch(uint8_t* const* frames, int n, int frame_w,
                           const uint8_t* comps, int comp_rows, int r0,
                           int comp_h, int comp_w,
                           const uint8_t* mask01,
                           int y0, int band_h, int band_w,
                           int n_threads) {
  const PasteGeometry g(frame_w, r0, r0 + comp_rows, comp_h, comp_w, mask01,
                        y0, band_h, band_w);
  const size_t comp_size = static_cast<size_t>(comp_rows) * comp_w * 3;
  return run_items(n, n_threads, [&](int j) {
    for (int y = 0; y < band_h; ++y) g.paste(frames[j], comps + j * comp_size, y);
  });
}

// Bilinear resize of a band crop (rows [y0, y0+crop_h) of the frame) to
// out (out_h x out_w x 3). Used for the model-input downscale. Output rows
// are spread over at most n_threads pool workers.
void crop_resize(const uint8_t* frame, int frame_w,
                 int y0, int crop_h, int crop_w,
                 uint8_t* out, int out_h, int out_w,
                 int n_threads) {
  const CropGeometry g(frame_w, y0, crop_h, crop_w, out_h, out_w);
  run_items(out_h, n_threads, [&](int y) { g.resize(frame, out, y); });
}

// crop_resize over a chunk: frames[j] into out[j] (out: n x out_h x out_w
// x 3). Whole frames are spread over at most n_threads pool workers;
// returns how many took part.
int crop_resize_batch(const uint8_t* const* frames, int n, int frame_w,
                      int y0, int crop_h, int crop_w,
                      uint8_t* out, int out_h, int out_w,
                      int n_threads) {
  const CropGeometry g(frame_w, y0, crop_h, crop_w, out_h, out_w);
  const size_t out_size = static_cast<size_t>(out_h) * out_w * 3;
  return run_items(n, n_threads, [&](int j) {
    for (int y = 0; y < out_h; ++y) g.resize(frames[j], out + j * out_size, y);
  });
}

// Plain crop over a chunk: rows [y0, y0 + h), columns [x0, x0 + w) of
// frames[j] (frame_w wide) into out[j] (out: n x h x w x 3). Whole frames
// are spread over at most n_threads pool workers; returns how many took part.
int crop_batch(const uint8_t* const* frames, int n, int frame_w,
               int y0, int x0, int h, int w, uint8_t* out, int n_threads) {
  const size_t row = static_cast<size_t>(w) * 3;
  const size_t stride = static_cast<size_t>(frame_w) * 3;
  return run_items(n, n_threads, [&](int j) {
    const uint8_t* src = frames[j] + (static_cast<size_t>(y0) * frame_w + x0) * 3;
    uint8_t* dst = out + static_cast<size_t>(j) * h * row;
    for (int y = 0; y < h; ++y) std::memcpy(dst + y * row, src + y * stride, row);
  });
}

// One pass a frame over a chunk: dsts[j] (frame_h x frame_w x 3) becomes
// srcs[j] with the window rows [y0, y0 + h), columns [x0, x0 + w) taken
// from rows[j] (rows: n x h x w x 3), so each byte of dsts[j] is written
// once. Where dsts[j] is srcs[j], only the window is written. Whole frames
// are spread over at most n_threads pool workers; returns how many took part.
int compose_rows_batch(const uint8_t* const* srcs, uint8_t* const* dsts, int n,
                       int frame_h, int frame_w, const uint8_t* rows,
                       int y0, int x0, int h, int w, int n_threads) {
  const size_t line = static_cast<size_t>(frame_w) * 3;
  const size_t left = static_cast<size_t>(x0) * 3, mid = static_cast<size_t>(w) * 3;
  const size_t right = line - left - mid;
  return run_items(n, n_threads, [&](int j) {
    const uint8_t* src = srcs[j];
    uint8_t* dst = dsts[j];
    const bool in_place = src == dst;
    const uint8_t* win = rows + static_cast<size_t>(j) * h * mid;
    if (!in_place) std::memcpy(dst, src, static_cast<size_t>(y0) * line);
    for (int y = y0; y < y0 + h; ++y) {
      const size_t at = static_cast<size_t>(y) * line;
      if (!in_place) std::memcpy(dst + at, src + at, left);
      std::memcpy(dst + at + left, win + static_cast<size_t>(y - y0) * mid, mid);
      if (!in_place) std::memcpy(dst + at + left + mid, src + at + left + mid, right);
    }
    if (!in_place) {
      const size_t below = static_cast<size_t>(y0 + h) * line;
      std::memcpy(dst + below, src + below, static_cast<size_t>(frame_h) * line - below);
    }
  });
}

}  // extern "C"
