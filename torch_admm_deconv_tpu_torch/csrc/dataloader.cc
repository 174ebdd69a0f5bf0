// Native data-loading runtime: multithreaded image decode + paired augment.
//
// The reference has no native runtime at all (SURVEY.md §2: 100% Python; its
// DataLoader decodes on the main Python thread and ships every image to the
// device one by one, dataload.py:30-31). On TPU the host must keep the
// device fed while the jitted step runs, so this library implements the
// input pipeline in C++: a worker pool decodes PNG/JPEG pairs, applies the
// paired random crop (identical window on x and y), /255 scaling and AWGN
// noise (x only), and assembles float32 NCHW batches into a bounded
// prefetch queue. Exposed through a minimal C API consumed via ctypes
// (runtime/native.py) — no pybind11 dependency.
//
// Transform semantics mirror data/transforms.py (RandCrop / Scale /
// AddAWGN with sigma ~ UniformInt[min_std, max_std)/255, clamp [0,1]).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC, 8-bit
};

bool decode_png(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_stdio(&img, fp)) {
    std::fclose(fp);
    return false;
  }
  img.format = PNG_FORMAT_RGB;
  out->h = img.height;
  out->w = img.width;
  out->c = 3;
  out->data.resize(PNG_IMAGE_SIZE(img));
  bool ok = png_image_finish_read(&img, nullptr, out->data.data(), 0, nullptr);
  std::fclose(fp);
  return ok;
}

bool decode_jpeg(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = 3;
  out->data.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return true;
}

bool has_suffix(const std::string& s, const char* suf) {
  std::string lower = s;
  for (auto& ch : lower) ch = std::tolower(ch);
  std::string t(suf);
  return lower.size() >= t.size() && lower.compare(lower.size() - t.size(), t.size(), t) == 0;
}

bool decode(const std::string& path, Image* out) {
  if (has_suffix(path, ".png")) return decode_png(path.c_str(), out);
  if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg"))
    return decode_jpeg(path.c_str(), out);
  // try png then jpeg
  return decode_png(path.c_str(), out) || decode_jpeg(path.c_str(), out);
}

struct Batch {
  std::vector<float> x, y;  // NCHW
};

struct Loader {
  std::vector<std::string> x_paths, y_paths;
  int batch = 1, crop_h = 0, crop_w = 0;
  int min_std = 0, max_std = 0;  // AWGN sigma range (0 => off)
  bool shuffle = true;
  uint64_t seed = 0;

  std::vector<std::thread> workers;
  std::deque<Batch> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t max_queue = 4;
  std::atomic<bool> stop{false};

  // epoch order handed out batch-by-batch
  std::vector<int> order;
  size_t next_batch_start = 0;
  std::mutex order_mu;
  std::mt19937_64 order_rng;

  size_t n() const { return x_paths.size(); }
  size_t batches_per_epoch() const { return n() / batch; }

  void reshuffle_locked() {
    order.resize(n());
    for (size_t i = 0; i < n(); ++i) order[i] = int(i);
    if (shuffle) {
      std::shuffle(order.begin(), order.end(), order_rng);
    }
    next_batch_start = 0;
  }

  // returns indices for one batch, reshuffling at epoch end
  std::vector<int> take_batch() {
    std::lock_guard<std::mutex> lk(order_mu);
    if (next_batch_start + batch > batches_per_epoch() * size_t(batch)) {
      reshuffle_locked();
    }
    std::vector<int> idx(order.begin() + next_batch_start,
                         order.begin() + next_batch_start + batch);
    next_batch_start += batch;
    return idx;
  }

  void worker(uint64_t wseed) {
    std::mt19937_64 rng(wseed);
    while (!stop.load()) {
      std::vector<int> idx = take_batch();
      Batch b;
      size_t plane = size_t(crop_h) * crop_w;
      b.x.resize(size_t(batch) * 3 * plane);
      b.y.resize(size_t(batch) * 3 * plane);
      bool ok_all = true;
      for (int bi = 0; bi < batch; ++bi) {
        Image xi, yi;
        if (!decode(x_paths[idx[bi]], &xi) || !decode(y_paths[idx[bi]], &yi) ||
            xi.h < crop_h || xi.w < crop_w || yi.h != xi.h || yi.w != xi.w) {
          ok_all = false;
          break;
        }
        // paired random crop
        std::uniform_int_distribution<int> dt(0, xi.h - crop_h);
        std::uniform_int_distribution<int> dl(0, xi.w - crop_w);
        int top = dt(rng), left = dl(rng);
        // AWGN sigma ~ UniformInt[min,max)/255 on x only
        float sigma = 0.f;
        if (max_std > 0) {
          std::uniform_int_distribution<int> ds(min_std, std::max(min_std, max_std - 1));
          sigma = float(ds(rng)) / 255.f;
        }
        std::normal_distribution<float> gauss(0.f, 1.f);
        for (int ch = 0; ch < 3; ++ch) {
          float* xo = b.x.data() + (size_t(bi) * 3 + ch) * plane;
          float* yo = b.y.data() + (size_t(bi) * 3 + ch) * plane;
          for (int r = 0; r < crop_h; ++r) {
            const uint8_t* xr = xi.data.data() + (size_t(top + r) * xi.w + left) * 3 + ch;
            const uint8_t* yr = yi.data.data() + (size_t(top + r) * yi.w + left) * 3 + ch;
            for (int col = 0; col < crop_w; ++col) {
              float xv = float(xr[size_t(col) * 3]) / 255.f;
              float yv = float(yr[size_t(col) * 3]) / 255.f;
              if (sigma > 0.f) {
                xv += sigma * gauss(rng);
                xv = xv < 0.f ? 0.f : (xv > 1.f ? 1.f : xv);
              }
              xo[size_t(r) * crop_w + col] = xv;
              yo[size_t(r) * crop_w + col] = yv;
            }
          }
        }
      }
      if (!ok_all) continue;  // skip unreadable pairs
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return queue.size() < max_queue || stop.load(); });
      if (stop.load()) return;
      queue.push_back(std::move(b));
      cv_pop.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* tad_loader_create(const char** x_paths, const char** y_paths, int n,
                        int batch, int crop_h, int crop_w, int min_std,
                        int max_std, int shuffle, uint64_t seed, int n_threads,
                        int max_queue) {
  auto* L = new Loader();
  L->x_paths.assign(x_paths, x_paths + n);
  L->y_paths.assign(y_paths, y_paths + n);
  L->batch = batch;
  L->crop_h = crop_h;
  L->crop_w = crop_w;
  L->min_std = min_std;
  L->max_std = max_std;
  L->shuffle = shuffle != 0;
  L->seed = seed;
  L->order_rng.seed(seed);
  L->max_queue = max_queue > 0 ? size_t(max_queue) : 4;
  {
    std::lock_guard<std::mutex> lk(L->order_mu);
    L->reshuffle_locked();
  }
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back([L, i] { L->worker(L->seed * 2654435761u + 1 + i); });
  return L;
}

// Blocks until a batch is ready; copies into caller-provided float32 NCHW
// buffers of shape (batch, 3, crop_h, crop_w). Returns 0 on success.
int tad_loader_next(void* handle, float* x_out, float* y_out) {
  auto* L = static_cast<Loader*>(handle);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_pop.wait(lk, [&] { return !L->queue.empty() || L->stop.load(); });
    if (L->queue.empty()) return 1;
    b = std::move(L->queue.front());
    L->queue.pop_front();
    L->cv_push.notify_one();
  }
  std::memcpy(x_out, b.x.data(), b.x.size() * sizeof(float));
  std::memcpy(y_out, b.y.data(), b.y.size() * sizeof(float));
  return 0;
}

int tad_loader_batches_per_epoch(void* handle) {
  return int(static_cast<Loader*>(handle)->batches_per_epoch());
}

void tad_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
