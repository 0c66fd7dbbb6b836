// Native JPEG decode + augment + batch pipeline.
//
// The port's counterpart of the JAX package's mxnet_tpu/native/
// image_pipeline.cc (itself the reference's threaded parser pipeline of
// src/io/iter_image_recordio_2.cc with the default augmenter chain of
// src/io/image_aug_default.cc). Worker threads pull shuffled record
// ranges from the mmap'd RecordIO file (recordio.cc), decode JPEG
// through the codec the build found (jpeg_libjpeg.cc or jpeg_nvjpeg.cc,
// behind jpeg_codec.h), resize-shorter-side (bilinear),
// random/center-crop, mirror, normalize ((v - mean) / std), and write
// float32 batches in NCHW or NHWC directly. The arithmetic after the
// decode is the JAX package's, line for line, so one file, seed and set
// of arguments give bit-equal batches where both decode with libjpeg.
// Each worker decodes with a decoder of its own, made when the pipeline
// is created and kept across epochs. A record that does not decode is
// counted and its slot zeroed; a fault of the decoder itself stops the
// pipeline, and imgpipe_next returns nullptr with imgpipe_error set.
//
// Image record framing (bit-compatible with the reference
// pack/pack_img, python/mxnet/recordio.py:362-495):
//   IRHeader: u32 flag | f32 label | u64 id | u64 id2
//   if flag > 0: flag * f32 label array
//   then the encoded (JPEG) image bytes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "jpeg_codec.h"

extern "C" {
int64_t rio_count(void* reader);
int64_t rio_get(void* reader, int64_t i, const uint8_t** ptr);
}

namespace {

// -- bilinear resize (HWC uint8), the image_aug_default resize role ----------

void resize_bilinear(const std::vector<uint8_t>& src, int sw, int sh, int c,
                     int dw, int dh, std::vector<uint8_t>* dst) {
  dst->resize(static_cast<size_t>(dw) * dh * c);
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = std::max(0, std::min(sh - 1, static_cast<int>(fy)));
    int y1 = std::min(sh - 1, y0 + 1);
    float wy = std::max(0.0f, std::min(1.0f, fy - y0));
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = std::max(0, std::min(sw - 1, static_cast<int>(fx)));
      int x1 = std::min(sw - 1, x0 + 1);
      float wx = std::max(0.0f, std::min(1.0f, fx - x0));
      for (int ch = 0; ch < c; ++ch) {
        float v00 = src[(static_cast<size_t>(y0) * sw + x0) * c + ch];
        float v01 = src[(static_cast<size_t>(y0) * sw + x1) * c + ch];
        float v10 = src[(static_cast<size_t>(y1) * sw + x0) * c + ch];
        float v11 = src[(static_cast<size_t>(y1) * sw + x1) * c + ch];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        (*dst)[(static_cast<size_t>(y) * dw + x) * c + ch] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// -- the pipeline -------------------------------------------------------------

struct ImgBatch {
  std::vector<float> data;
  std::vector<float> labels;
  int64_t n = 0;
  int64_t pad = 0;      // wrap-padded duplicates in this batch
  uint64_t seq = 0;     // batch index within the epoch (delivery order)
};

struct ImagePipeline {
  void* reader = nullptr;
  int batch = 0, H = 0, W = 0, C = 3, resize = 0, label_width = 1;
  float label_pad_value = 0.0f;
  bool force_resize = false;  // warp to (W,H), no crop (det mode)
  bool rand_crop = false, rand_mirror = false, shuffle = false, nhwc = false;
  float mean[3] = {0, 0, 0}, stdv[3] = {1, 1, 1};
  uint64_t seed = 0;
  int epoch = 0;

  std::vector<uint32_t> order;
  size_t cursor = 0;
  std::mutex cursor_mu;

  // batches are produced by whichever worker finishes first but MUST be
  // consumed in epoch order (reference ImageRecordIter2 is deterministic
  // per seed): workers insert keyed by seq, the consumer pops next_out.
  // Backpressure is a sliding window over seq (not queue size) so the
  // worker holding next_out can never be blocked out by later batches.
  std::map<uint64_t, ImgBatch*> ready;
  uint64_t next_out = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t max_ready = 4;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int> active{0};
  std::atomic<int64_t> decode_failures{0};
  std::vector<JpegDecoder*> decoders;  // one per worker, for the pipeline's life
  std::string error;                   // a decoder fault, under mu; sticky

  ~ImagePipeline() {
    shutdown();
    for (JpegDecoder* d : decoders) jpeg_decoder_destroy(d);
  }

  void fail(const std::string& why) {
    {
      std::lock_guard<std::mutex> lk(mu);
      if (error.empty()) error = why.empty() ? "decoder fault" : why;
    }
    cv_ready.notify_all();
    cv_space.notify_all();
  }

  void reset_order() {
    int64_t n = rio_count(reader);
    order.resize(static_cast<size_t>(n));
    for (uint32_t i = 0; i < order.size(); ++i) order[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
      std::shuffle(order.begin(), order.end(), rng);
    }
    cursor = 0;
  }

  bool next_indices(std::vector<uint32_t>* idx, uint64_t* batch_id,
                    int64_t* pad) {
    std::lock_guard<std::mutex> lk(cursor_mu);
    if (cursor >= order.size()) return false;
    *batch_id = cursor / static_cast<size_t>(batch);
    size_t end = std::min(cursor + static_cast<size_t>(batch),
                          order.size());
    idx->assign(order.begin() + cursor, order.begin() + end);
    cursor = end;
    size_t need = batch - idx->size();  // pad final batch by wrapping
    *pad = static_cast<int64_t>(need);
    for (size_t i = 0; i < need; ++i) idx->push_back(order[i % order.size()]);
    return true;
  }

  // one sample: record -> decode -> resize -> crop -> mirror -> normalize
  JpegStatus process_one(JpegDecoder* dec, const uint8_t* rec, int64_t len,
                         float* out_img, float* out_label,
                         std::mt19937_64* rng, std::string* err) {
    if (len < 24) return kJpegBadImage;
    uint32_t flag;
    float flabel;
    std::memcpy(&flag, rec, 4);
    std::memcpy(&flabel, rec + 4, 4);
    const uint8_t* p = rec + 24;
    int64_t remain = len - 24;
    if (flag > 0) {
      int64_t lbytes = static_cast<int64_t>(flag) * 4;
      if (remain < lbytes) return kJpegBadImage;
      for (int i = 0; i < label_width; ++i) {
        float v = label_pad_value;
        if (i < static_cast<int>(flag)) std::memcpy(&v, p + i * 4, 4);
        out_label[i] = v;
      }
      p += lbytes;
      remain -= lbytes;
    } else {
      out_label[0] = flabel;
      for (int i = 1; i < label_width; ++i) out_label[i] = label_pad_value;
    }

    std::vector<uint8_t> img;
    int w = 0, h = 0;
    const JpegStatus st = jpeg_decode(dec, p, static_cast<size_t>(remain),
                                      C, &img, &w, &h, err);
    if (st != kJpegOk) return st;

    std::vector<uint8_t> resized;
    if (force_resize) {
      // warp to the exact output size: normalized box labels stay
      // valid (the det augmenter's default, image_det_aug_default.cc)
      if (w != W || h != H) {
        resize_bilinear(img, w, h, C, W, H, &resized);
        img.swap(resized);
        w = W;
        h = H;
      }
    }
    // resize shorter side (image_aug_default.cc resize param)
    if (!force_resize && resize > 0 && std::min(w, h) != resize) {
      int nw, nh;
      if (w < h) {
        nw = resize;
        nh = static_cast<int>(static_cast<int64_t>(h) * resize / w);
      } else {
        nh = resize;
        nw = static_cast<int>(static_cast<int64_t>(w) * resize / h);
      }
      resize_bilinear(img, w, h, C, nw, nh, &resized);
      img.swap(resized);
      w = nw;
      h = nh;
    }
    // if still smaller than the crop, scale up to fit
    if (w < W || h < H) {
      int nw = std::max(w, W), nh = std::max(h, H);
      resize_bilinear(img, w, h, C, nw, nh, &resized);
      img.swap(resized);
      w = nw;
      h = nh;
    }
    // crop
    const float inv_std[3] = {1.0f / stdv[0], 1.0f / stdv[1],
                              1.0f / stdv[2]};
    int x0, y0;
    if (rand_crop) {
      x0 = w == W ? 0 : static_cast<int>((*rng)() % (w - W + 1));
      y0 = h == H ? 0 : static_cast<int>((*rng)() % (h - H + 1));
    } else {
      x0 = (w - W) / 2;
      y0 = (h - H) / 2;
    }
    bool mirror = rand_mirror && ((*rng)() & 1);

    if (nhwc) {
      for (int y = 0; y < H; ++y) {
        const uint8_t* src_row =
            img.data() + (static_cast<size_t>(y0 + y) * w + x0) * C;
        float* dst_row = out_img + (static_cast<size_t>(y) * W) * C;
        for (int x = 0; x < W; ++x) {
          int sx = mirror ? (W - 1 - x) : x;
          for (int ch = 0; ch < C; ++ch)
            dst_row[x * C + ch] =
                (static_cast<float>(src_row[sx * C + ch]) - mean[ch]) *
                inv_std[ch];
        }
      }
    } else {
      // NCHW: write each channel plane contiguously (strided reads are
      // cheaper than strided writes)
      for (int ch = 0; ch < C; ++ch) {
        float* plane = out_img + static_cast<size_t>(ch) * H * W;
        const float m = mean[ch], is = inv_std[ch];
        for (int y = 0; y < H; ++y) {
          const uint8_t* src_row =
              img.data() + (static_cast<size_t>(y0 + y) * w + x0) * C + ch;
          float* dst_row = plane + static_cast<size_t>(y) * W;
          if (mirror) {
            for (int x = 0; x < W; ++x)
              dst_row[x] =
                  (static_cast<float>(src_row[(W - 1 - x) * C]) - m) * is;
          } else {
            for (int x = 0; x < W; ++x)
              dst_row[x] = (static_cast<float>(src_row[x * C]) - m) * is;
          }
        }
      }
    }
    return kJpegOk;
  }

  void worker_loop(JpegDecoder* dec) {
    std::vector<uint32_t> idx;
    uint64_t batch_id = 0;
    int64_t pad = 0;
    while (!stop.load()) {
      if (!next_indices(&idx, &batch_id, &pad)) break;
      std::mt19937_64 rng(seed * 1000003u + epoch * 10007u + batch_id);
      ImgBatch* b = new ImgBatch();
      b->pad = pad;
      b->seq = batch_id;
      size_t img_elems = static_cast<size_t>(C) * H * W;
      b->data.resize(static_cast<size_t>(batch) * img_elems);
      b->labels.resize(static_cast<size_t>(batch) * label_width);
      b->n = batch;
      std::string err;
      bool faulted = false;
      for (size_t k = 0; k < idx.size() && !faulted; ++k) {
        const uint8_t* rec = nullptr;
        int64_t len = rio_get(reader, idx[k], &rec);
        const JpegStatus st =
            len <= 0 ? kJpegBadImage
                     : process_one(dec, rec, len,
                                   b->data.data() + k * img_elems,
                                   b->labels.data() + k * label_width, &rng,
                                   &err);
        if (st == kJpegDecoderFault) {
          faulted = true;
        } else if (st == kJpegBadImage) {
          decode_failures.fetch_add(1);
          std::memset(b->data.data() + k * img_elems, 0,
                      img_elems * sizeof(float));
          std::memset(b->labels.data() + k * label_width, 0,
                      label_width * sizeof(float));
        }
      }
      if (faulted) {
        delete b;
        fail(err);
        break;
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [this, b] {
        return b->seq < next_out + max_ready || stop.load() ||
               !error.empty();
      });
      if (stop.load() || !error.empty()) {
        delete b;
        active.fetch_sub(1);
        cv_ready.notify_all();
        return;
      }
      ready.emplace(b->seq, b);
      cv_ready.notify_all();
    }
    // end-of-epoch is detected by the consumer: active==0 and the
    // reorder map fully drained; just wake it up
    active.fetch_sub(1);
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.notify_all();
  }

  // makes the workers' decoders: false (and `error` set) if one fails
  bool make_decoders(int num_workers) {
    for (int i = 0; i < num_workers; ++i) {
      std::string err;
      JpegDecoder* d = jpeg_decoder_create(&err);
      if (!d) {
        fail(err);
        return false;
      }
      decoders.push_back(d);
    }
    return true;
  }

  void start() {
    stop.store(false);
    reset_order();
    next_out = 0;
    {
      std::lock_guard<std::mutex> lk(mu);
      if (!error.empty()) return;  // a fault stays: nothing more is decoded
    }
    active.store(static_cast<int>(decoders.size()));
    for (JpegDecoder* d : decoders)
      workers.emplace_back([this, d] { worker_loop(d); });
  }

  void shutdown() {
    {
      // set stop under mu: a worker that just evaluated its cv_space
      // predicate (stop still false) but not yet blocked would miss an
      // unsynchronized notify and sleep forever, hanging the join
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    for (auto& kv : ready) delete kv.second;
    ready.clear();
  }
};

}  // namespace

extern "C" {

void* imgpipe_create(void* reader, int batch, int channels, int height,
                     int width, int resize, int label_width, int rand_crop,
                     int rand_mirror, int shuffle, int nhwc,
                     const float* mean3, const float* std3, uint64_t seed,
                     int num_workers, float label_pad_value,
                     int force_resize) {
  if (batch <= 0 || !reader) return nullptr;
  ImagePipeline* p = new ImagePipeline();
  p->reader = reader;
  p->batch = batch;
  p->C = channels;
  p->H = height;
  p->W = width;
  p->resize = resize;
  p->label_width = label_width > 0 ? label_width : 1;
  p->label_pad_value = label_pad_value;
  p->force_resize = force_resize != 0;
  p->rand_crop = rand_crop != 0;
  p->rand_mirror = rand_mirror != 0;
  p->shuffle = shuffle != 0;
  p->nhwc = nhwc != 0;
  if (mean3)
    for (int i = 0; i < 3; ++i) p->mean[i] = mean3[i];
  if (std3)
    for (int i = 0; i < 3; ++i) p->stdv[i] = std3[i] != 0 ? std3[i] : 1.0f;
  p->seed = seed;
  if (p->make_decoders(num_workers > 0 ? num_workers : 2)) p->start();
  return p;
}

// Returns an ImgBatch* or nullptr at end of epoch. Batches come out in
// epoch order (seq 0, 1, 2, ...) regardless of worker completion order.
void* imgpipe_next(void* pipe) {
  ImagePipeline* p = static_cast<ImagePipeline*>(pipe);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [p] {
    return p->ready.count(p->next_out) || p->stop.load() ||
           !p->error.empty() || (p->active.load() == 0 && p->ready.empty());
  });
  if (!p->error.empty()) return nullptr;  // the caller reads imgpipe_error
  auto it = p->ready.find(p->next_out);
  if (it == p->ready.end()) return nullptr;  // epoch done or stopping
  ImgBatch* b = it->second;
  p->ready.erase(it);
  p->next_out += 1;
  p->cv_space.notify_all();  // window slid: several workers may now fit
  return b;
}

const float* imgpipe_batch_data(void* batch) {
  return static_cast<ImgBatch*>(batch)->data.data();
}

const float* imgpipe_batch_labels(void* batch) {
  return static_cast<ImgBatch*>(batch)->labels.data();
}

int64_t imgpipe_batch_n(void* batch) {
  return static_cast<ImgBatch*>(batch)->n;
}

int64_t imgpipe_batch_pad(void* batch) {
  return static_cast<ImgBatch*>(batch)->pad;
}

void imgpipe_batch_free(void* batch) { delete static_cast<ImgBatch*>(batch); }

void imgpipe_reset(void* pipe) {
  ImagePipeline* p = static_cast<ImagePipeline*>(pipe);
  p->shutdown();
  p->epoch += 1;
  p->start();
}

// The decoder fault that stopped the pipeline, or nullptr.
const char* imgpipe_error(void* pipe) {
  ImagePipeline* p = static_cast<ImagePipeline*>(pipe);
  std::lock_guard<std::mutex> lk(p->mu);
  return p->error.empty() ? nullptr : p->error.c_str();
}

int64_t imgpipe_decode_failures(void* pipe) {
  return static_cast<ImagePipeline*>(pipe)->decode_failures.load();
}

void imgpipe_destroy(void* pipe) { delete static_cast<ImagePipeline*>(pipe); }

// One image through the pipeline's codec: HWC uint8 (malloc'd; free with
// imgpipe_decode_free) and its width and height, or nullptr with *status
// a JpegStatus and, for a decoder fault, its message in `err` (`errlen`
// bytes). One decoder serves every call, one call at a time; it is made at
// the first and never freed (the CUDA runtime may be gone by the time a
// static destructor would run).
uint8_t* imgpipe_decode(const uint8_t* buf, int64_t len, int channels,
                        int* w, int* h, int* status, char* err,
                        int64_t errlen) {
  static std::mutex mu;
  static JpegDecoder* dec = nullptr;
  std::lock_guard<std::mutex> lk(mu);
  std::string why;
  std::vector<uint8_t> img;
  JpegStatus st = kJpegBadImage;
  if (!dec) dec = jpeg_decoder_create(&why);
  if (!dec)
    st = kJpegDecoderFault;
  else if (len > 0)
    st = jpeg_decode(dec, buf, static_cast<size_t>(len), channels, &img, w,
                     h, &why);
  *status = st;
  if (st != kJpegOk) {
    if (err && errlen > 0)
      std::snprintf(err, static_cast<size_t>(errlen), "%s", why.c_str());
    return nullptr;
  }
  uint8_t* out = static_cast<uint8_t*>(std::malloc(img.size()));
  if (out) std::memcpy(out, img.data(), img.size());
  return out;
}

void imgpipe_decode_free(uint8_t* img) { std::free(img); }

const char* imgpipe_codec() { return jpeg_codec_name(); }

}  // extern "C"
