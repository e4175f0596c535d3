// Native multithreaded snippet-batch loader of davo_tpu_torch (a copy of
// tools/native_loader/snippet_loader.cc, the loader of the reference's
// offline-prepared triplet layout, davo_tpu/data/prep.py), decoding with
// the port's own codec (image_codec.h) in place of libjpeg and libpng,
// plus the single-image entry points that data/imageio.py binds. The
// Python reader (`PreparedSnippets`) decodes serially on the training
// thread; this loader overlaps decode across a thread pool and
// double-buffers assembled batches so `snl_next` is a memcpy when decode
// keeps up.
//
// Layout per item `<name>`:
//   <dir>/<name>.jpg      H x 3W RGB JPEG: [prev | target | next]
//   <dir>/<name>_cam.txt  9 comma-separated intrinsics (row-major K)
//   <dir>/<name>_seg.png  optional H x W 8-bit label map (target frame)
//   <dir>/<name>_pose.txt optional 32 comma-separated floats: two 4x4
//                         GT warp transforms (target->each source)
//
// Batch output (float32 RGB in [0,1]; seg int32 labels):
//   target  (B, H, W, 3)
//   sources (B, 2, H, W, 3)   [prev, next]
//   K       (B, 3, 3)
//   seg     (B, H, W)         when created with with_seg
//   gt      (B, 2, 4, 4)      when created with with_gt
//
// Built with g++ at first use by davo_tpu_torch/data/imageio.py
// (links zlib and pthread).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "image_codec.h"

namespace {

constexpr int kNumBuffers = 3;  // ready-queue depth (prefetch window)

// Read `count` comma/space-separated floats from a small text file.
bool read_floats(const std::string& path, float* out, int count,
                 std::string* error) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    *error = "open failed: " + path;
    return false;
  }
  char buf[2048];
  size_t n = fread(buf, 1, sizeof(buf) - 1, f);
  fclose(f);
  buf[n] = 0;
  char* p = buf;
  for (int i = 0; i < count; ++i) {
    char* end = nullptr;
    out[i] = strtof(p, &end);
    if (end == p) {
      *error = "bad float file: " + path;
      return false;
    }
    p = end;
    while (*p == ',' || *p == ' ' || *p == '\n') ++p;
  }
  return true;
}

// Decode <name>_seg.png (8-bit gray H x W) into int32 labels.
bool decode_seg(const std::string& path, int H, int W, int32_t* out,
                std::string* error) {
  dvimg::Image img;
  if (!dvimg::decode_file(path, 0, &img, error)) return false;
  if (img.h != H || img.w != W || img.c != 1) {
    char b[96];
    snprintf(b, sizeof(b), " (%dx%d with %d channels, want %dx%d gray8)",
             img.h, img.w, img.c, H, W);
    *error = "seg shape mismatch: " + path + b;
    return false;
  }
  for (size_t i = 0; i < img.px.size(); ++i) out[i] = img.px[i];
  return true;
}

// Decode one triplet JPEG + cam file directly into the batch slot.
// Returns false (and fills *error) on any failure.
bool decode_item(const std::string& dir, const std::string& name, int H,
                 int W, float* target, float* sources, float* Kout,
                 std::string* error) {
  const std::string jpg = dir + "/" + name + ".jpg";
  dvimg::Image img;
  if (!dvimg::decode_file(jpg, 3, &img, error)) return false;
  if (img.h != H || img.w != 3 * W) {
    char buf[128];
    snprintf(buf, sizeof(buf), " (got %dx%dx3, want %dx%dx3)", img.h, img.w,
             H, 3 * W);
    *error = "shape mismatch: " + jpg + buf;
    return false;
  }
  // Divided, not multiplied by 1/255: the Python reader's float32
  // division, so both readers give the same floats.
  const int64_t frame = static_cast<int64_t>(H) * W * 3;
  for (int r = 0; r < H; ++r) {
    const uint8_t* row = img.px.data() + static_cast<int64_t>(r) * 3 * W * 3;
    float* tgt_row = target + static_cast<int64_t>(r) * W * 3;
    float* prev_row = sources + static_cast<int64_t>(r) * W * 3;
    float* next_row = sources + frame + static_cast<int64_t>(r) * W * 3;
    const uint8_t* prev_px = row;
    const uint8_t* tgt_px = row + W * 3;
    const uint8_t* next_px = row + 2 * W * 3;
    for (int i = 0; i < W * 3; ++i) {
      prev_row[i] = prev_px[i] / 255.0f;
      tgt_row[i] = tgt_px[i] / 255.0f;
      next_row[i] = next_px[i] / 255.0f;
    }
  }
  return read_floats(dir + "/" + name + "_cam.txt", Kout, 9, error);
}

struct BatchBuffer {
  std::vector<float> target, sources, K, gt;
  std::vector<int32_t> seg;
  int filled = 0;           // decoded items in this buffer
  int assigned = 0;         // items handed to workers
  enum State { FREE, FILLING, READY } state = FREE;
  uint64_t seq = 0;         // global batch index (consume ordering)
};

struct Loader {
  std::string dir;
  std::vector<std::string> names;
  int batch, H, W;
  bool shuffle, loop, with_seg = false, with_gt = false;
  std::mt19937_64 rng;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_worker, cv_consumer;
  BatchBuffer buffers[kNumBuffers];
  std::vector<uint32_t> order;  // current epoch permutation
  size_t epoch_pos = 0;         // next item within the epoch
  size_t epoch_len = 0;         // items used per epoch (tail dropped)
  uint64_t batches_produced = 0, batches_consumed = 0;
  bool epochs_done = false;     // !loop and final epoch fully assigned
  bool stopping = false;
  std::string error;

  void new_epoch() {
    order.resize(names.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    if (shuffle) {
      for (size_t i = order.size() - 1; i > 0; --i) {
        std::uniform_int_distribution<size_t> d(0, i);
        std::swap(order[i], order[d(rng)]);
      }
    }
    epoch_len = (names.size() / batch) * batch;  // drop ragged tail
    epoch_pos = 0;
  }

  // Under mu: find (or open) the buffer accepting new work.
  BatchBuffer* filling_buffer() {
    for (auto& b : buffers)
      if (b.state == BatchBuffer::FILLING && b.assigned < batch) return &b;
    for (auto& b : buffers) {
      if (b.state == BatchBuffer::FREE) {
        b.state = BatchBuffer::FILLING;
        b.filled = b.assigned = 0;
        b.seq = batches_produced++;
        return &b;
      }
    }
    return nullptr;  // all buffers busy; worker must wait
  }

  void worker_main() {
    for (;;) {
      BatchBuffer* buf = nullptr;
      std::string name;
      int slot = -1;
      {
        std::unique_lock<std::mutex> lk(mu);
        for (;;) {
          if (stopping || !error.empty()) return;
          if (epoch_pos >= epoch_len) {
            if (!loop) {
              epochs_done = true;
              cv_consumer.notify_all();
              cv_worker.wait(lk);
              continue;
            }
            new_epoch();
          }
          buf = filling_buffer();
          if (buf) break;
          cv_worker.wait(lk);
        }
        slot = buf->assigned++;
        name = names[order[epoch_pos++]];
      }

      const int64_t frame = static_cast<int64_t>(H) * W * 3;
      std::string err;
      bool ok = decode_item(
          dir, name, H, W, buf->target.data() + slot * frame,
          buf->sources.data() + slot * 2 * frame, buf->K.data() + slot * 9,
          &err);
      if (ok && with_seg) {
        ok = decode_seg(dir + "/" + name + "_seg.png", H, W,
                        buf->seg.data() + static_cast<int64_t>(slot) * H * W,
                        &err);
      }
      if (ok && with_gt) {
        ok = read_floats(dir + "/" + name + "_pose.txt",
                         buf->gt.data() + slot * 32, 32, &err);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (!ok && error.empty()) error = err;
        if (++buf->filled == batch) {
          buf->state = BatchBuffer::READY;
          cv_consumer.notify_all();
        }
        if (!ok) cv_consumer.notify_all();
      }
    }
  }

  // 1 = batch copied out, 0 = end of data, -1 = error.
  int next(float* target, float* sources, float* K, int32_t* seg,
           float* gt) {
    std::unique_lock<std::mutex> lk(mu);
    BatchBuffer* buf = nullptr;
    for (;;) {
      if (!error.empty()) return -1;
      for (auto& b : buffers)
        if (b.state == BatchBuffer::READY && b.seq == batches_consumed) {
          buf = &b;
          break;
        }
      if (buf) break;
      // End: final epoch fully assigned and no buffer will become
      // READY for our seq (it was never opened).
      if (epochs_done && batches_produced <= batches_consumed) return 0;
      cv_consumer.wait(lk);
    }
    lk.unlock();
    const int64_t frame = static_cast<int64_t>(H) * W * 3;
    memcpy(target, buf->target.data(), sizeof(float) * batch * frame);
    memcpy(sources, buf->sources.data(), sizeof(float) * batch * 2 * frame);
    memcpy(K, buf->K.data(), sizeof(float) * batch * 9);
    if (with_seg && seg)
      memcpy(seg, buf->seg.data(),
             sizeof(int32_t) * static_cast<int64_t>(batch) * H * W);
    if (with_gt && gt)
      memcpy(gt, buf->gt.data(), sizeof(float) * batch * 32);
    lk.lock();
    buf->state = BatchBuffer::FREE;
    ++batches_consumed;
    cv_worker.notify_all();
    return 1;
  }
};

}  // namespace

extern "C" {

// names_blob: '\n'-joined item names.
void* snl_create(const char* dir, const char* names_blob, int batch,
                 int height, int width, int n_threads,
                 unsigned long long seed, int shuffle, int loop,
                 int with_seg, int with_gt) {
  auto* L = new Loader;
  L->dir = dir;
  const char* p = names_blob;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : strlen(p);
    if (len) L->names.emplace_back(p, len);
    p += len + (nl ? 1 : 0);
  }
  L->batch = batch;
  L->H = height;
  L->W = width;
  L->shuffle = shuffle != 0;
  L->loop = loop != 0;
  L->with_seg = with_seg != 0;
  L->with_gt = with_gt != 0;
  L->rng.seed(seed);
  if (L->names.empty() || static_cast<int>(L->names.size()) < batch) {
    delete L;
    return nullptr;
  }
  const int64_t frame = static_cast<int64_t>(height) * width * 3;
  for (auto& b : L->buffers) {
    b.target.resize(batch * frame);
    b.sources.resize(batch * 2 * frame);
    b.K.resize(batch * 9);
    if (L->with_seg)
      b.seg.resize(static_cast<int64_t>(batch) * height * width);
    if (L->with_gt) b.gt.resize(batch * 32);
  }
  L->new_epoch();
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    L->workers.emplace_back(&Loader::worker_main, L);
  return L;
}

int snl_next(void* h, float* target, float* sources, float* K,
             int32_t* seg, float* gt) {
  return static_cast<Loader*>(h)->next(target, sources, K, seg, gt);
}

// Copies the error message (empty string if none) into out.
void snl_error(void* h, char* out, int cap) {
  auto* L = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> lk(L->mu);
  snprintf(out, cap, "%s", L->error.c_str());
}

void snl_destroy(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stopping = true;
  }
  L->cv_worker.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// Probe a triplet's decoded dims without a full decode (header only).
// Returns 1 and fills h/w (w = per-frame width) on success.
int snl_probe(const char* path, int* h, int* w) {
  dvimg::Image img;
  std::string err;
  if (!dvimg::decode_file(path, 0, &img, &err, true)) return 0;
  *h = img.h;
  *w = img.w / 3;
  return 1;
}

// ---------------------------------------------------------------------------
// Single images (data/imageio.py). Each returns 0 on success, else -1
// with the reason in dv_last_error (per thread).
// ---------------------------------------------------------------------------

static thread_local std::string g_last_error;

static int fail(const std::string& err) {
  g_last_error = err;
  return -1;
}

void dv_last_error(char* out, int cap) { snprintf(out, cap, "%s", g_last_error.c_str()); }

// h, w and the stored channel count (1 gray, 3 colour) from the header.
int dv_image_info(const char* path, int* h, int* w, int* c) {
  dvimg::Image img;
  std::string err;
  if (!dvimg::decode_file(path, 0, &img, &err, true)) return fail(err);
  *h = img.h;
  *w = img.w;
  *c = img.c;
  return 0;
}

// Decode into `out` (h x w x channels uint8); channels 1 (gray files
// only) or 3 (gray replicated). The caller sized `out` from dv_image_info.
int dv_imread(const char* path, int channels, uint8_t* out, int h, int w) {
  dvimg::Image img;
  std::string err;
  if (!dvimg::decode_file(path, channels, &img, &err)) return fail(err);
  if (img.h != h || img.w != w) return fail(std::string("image changed size: ") + path);
  memcpy(out, img.px.data(), img.px.size());
  return 0;
}

int dv_imwrite_jpeg(const char* path, const uint8_t* rgb, int h, int w, int quality) {
  std::vector<uint8_t> data;
  std::string err;
  if (!dvimg::encode_jpeg_rgb(rgb, h, w, quality, &data, &err) ||
      !dvimg::write_file(path, data, &err))
    return fail(err);
  return 0;
}

int dv_imwrite_png(const char* path, const uint8_t* px, int h, int w, int channels) {
  std::vector<uint8_t> data;
  std::string err;
  if (!dvimg::encode_png(px, h, w, channels, &data, &err) ||
      !dvimg::write_file(path, data, &err))
    return fail(err);
  return 0;
}

}  // extern "C"
