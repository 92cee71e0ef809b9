// Native stereo frame loader: threaded PNG/JPEG decode + geometric remap +
// photometric correction + bounded in-order prefetch.
//
// The reference's C++ data path, as the JAX package's native/loader.cpp
// builds it:
//   - util/DatasetReader.h (ImageFolderReader::getImage :200-226)
//   - IOWrapper/OpenCV/ImageRW_OpenCV.cpp (8/16-bit PNG read)
//   - util/Undistort.cpp remap application (Undistort::undistortGeneric)
//   - util/IndexThreadReduce.h (persistent worker pool)
// The decode+undistort work runs on host worker threads so the device
// pipeline never waits on image I/O.
//
// PNG is decoded here with zlib alone (signature, IHDR, IDAT inflate, the five
// row filters): a machine may have zlib but not libpng's headers, and then the
// loader still builds. Non-interlaced grey, grey+alpha, RGB and RGBA at 8 or
// 16 bits decode (KITTI's image_0/image_1 are 8-bit grey); palette, 1/2/4-bit
// and interlaced files are refused. JPEG is decoded with libjpeg when the
// library is built with SDSO_WITH_JPEG, and refused otherwise.
//
// C API (ctypes-friendly); all images float32 row-major.
//   sdso_decode_gray(path, out, out_cap, &w, &h)      one-shot decode
//   sdso_loader_open(...)                              start prefetch pool
//   sdso_loader_next(h, out_left, out_right)           blocking, in order
//   sdso_loader_close(h)
//
// Build: g++ -O3 -shared -fPIC loader.cpp -lz -lpthread
//        (with JPEG: -DSDSO_WITH_JPEG ... -ljpeg)

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef SDSO_WITH_JPEG
extern "C" {
#include <jpeglib.h>
}
#endif

namespace {

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

// Grayscale conversion weights matching the Python reader (io/dataset.py).
constexpr float kR = 0.299f, kG = 0.587f, kB = 0.114f;

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool read_file(const char* path, std::vector<uint8_t>& bytes) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  bytes.clear();
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof chunk, fp)) > 0)
    bytes.insert(bytes.end(), chunk, chunk + got);
  const bool ok = !std::ferror(fp);
  std::fclose(fp);
  return ok;
}

// Paeth predictor (PNG specification, section 9.4).
uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

bool decode_png_gray(const char* path, std::vector<float>& out, int* w,
                     int* h) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  std::vector<uint8_t> file;
  if (!read_file(path, file) || file.size() < 8 ||
      std::memcmp(file.data(), kSig, 8))
    return false;
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color = -1;
  bool have_ihdr = false, have_iend = false;
  std::vector<uint8_t> idat;
  for (size_t pos = 8; pos + 12 <= file.size();) {
    const uint32_t len = be32(&file[pos]);
    const uint8_t* type = &file[pos + 4];
    if (len > file.size() - pos - 12) return false;  // truncated chunk
    const uint8_t* data = &file[pos + 8];
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13) return false;
      width = be32(data);
      height = be32(data + 4);
      bit_depth = data[8];
      color = data[9];
      // compression 0, filter method 0, no interlace
      if (data[10] != 0 || data[11] != 0 || data[12] != 0) return false;
      have_ihdr = true;
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      have_iend = true;
      break;
    }
    pos += 12 + size_t(len);
  }
  if (!have_ihdr || !have_iend || width == 0 || height == 0 ||
      width > (1u << 16) || height > (1u << 16))
    return false;
  if (bit_depth != 8 && bit_depth != 16) return false;
  int channels;
  switch (color) {
    case 0: channels = 1; break;  // grey
    case 2: channels = 3; break;  // RGB
    case 4: channels = 2; break;  // grey + alpha
    case 6: channels = 4; break;  // RGBA
    default: return false;        // palette or invalid
  }
  const size_t bpp = size_t(channels) * (bit_depth / 8);
  const size_t rowbytes = bpp * width;
  uLongf raw_len = uLongf((rowbytes + 1) * height);
  std::vector<uint8_t> raw(raw_len);
  if (uncompress(raw.data(), &raw_len, idat.data(), uLong(idat.size())) !=
          Z_OK ||
      raw_len != (rowbytes + 1) * height)
    return false;
  // undo the row filters in place; row y's bytes follow its filter byte
  std::vector<uint8_t> zero(rowbytes, 0);
  for (uint32_t y = 0; y < height; y++) {
    uint8_t* cur = raw.data() + size_t(y) * (rowbytes + 1);
    const uint8_t filter = cur[0];
    cur += 1;
    const uint8_t* prev =
        y ? raw.data() + size_t(y - 1) * (rowbytes + 1) + 1 : zero.data();
    for (size_t i = 0; i < rowbytes; i++) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev[i];
      const int c = i >= bpp ? prev[i - bpp] : 0;
      switch (filter) {
        case 0: break;
        case 1: cur[i] = uint8_t(cur[i] + a); break;
        case 2: cur[i] = uint8_t(cur[i] + b); break;
        case 3: cur[i] = uint8_t(cur[i] + ((a + b) >> 1)); break;
        case 4: cur[i] = uint8_t(cur[i] + paeth(a, b, c)); break;
        default: return false;
      }
    }
  }
  out.resize(size_t(width) * height);
  const float scale16 = 255.0f / 65535.0f;  // match io/dataset.py 16-bit path
  for (uint32_t y = 0; y < height; y++) {
    const uint8_t* row = raw.data() + size_t(y) * (rowbytes + 1) + 1;
    float* dst = out.data() + size_t(y) * width;
    for (uint32_t x = 0; x < width; x++) {
      const uint8_t* px = row + x * bpp;
      if (bit_depth == 16) {
        const uint16_t r = uint16_t((px[0] << 8) | px[1]);
        if (channels < 3) {
          dst[x] = r * scale16;
        } else {
          const uint16_t g = uint16_t((px[2] << 8) | px[3]);
          const uint16_t b = uint16_t((px[4] << 8) | px[5]);
          dst[x] = (kR * r + kG * g + kB * b) * scale16;
        }
      } else if (channels < 3) {
        dst[x] = float(px[0]);
      } else {
        dst[x] = kR * px[0] + kG * px[1] + kB * px[2];
      }
    }
  }
  *w = int(width);
  *h = int(height);
  return true;
}

#ifdef SDSO_WITH_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

bool decode_jpeg_gray(const char* path, std::vector<float>& out, int* w,
                      int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;  // libjpeg uses ITU-R 601 weights
  jpeg_start_decompress(&cinfo);
  const int width = cinfo.output_width, height = cinfo.output_height;
  out.resize(size_t(width) * height);
  std::vector<uint8_t> row(width);
  uint8_t* rp = row.data();
  for (int y = 0; y < height; y++) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = out.data() + size_t(y) * width;
    for (int x = 0; x < width; x++) dst[x] = float(row[x]);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  *w = width;
  *h = height;
  return true;
}
#endif  // SDSO_WITH_JPEG

bool has_suffix(const char* s, const char* suf) {
  const size_t n = std::strlen(s), m = std::strlen(suf);
  return n >= m && !std::strcmp(s + n - m, suf);
}

bool decode_gray(const char* path, std::vector<float>& out, int* w, int* h) {
  if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg")) {
#ifdef SDSO_WITH_JPEG
    return decode_jpeg_gray(path, out, w, h);
#else
    return false;
#endif
  }
  return decode_png_gray(path, out, w, h);
}

// ---------------------------------------------------------------------------
// remap + photometric (the per-frame tail of ImageFolderReader::getImage)
// ---------------------------------------------------------------------------

struct Calibration {
  int out_w = 0, out_h = 0;      // final (cropped) size
  std::vector<float> remap_x;    // out_h*out_w source coords; <0 -> invalid
  std::vector<float> remap_y;
  std::vector<float> gamma;      // 256-entry inverse response (or empty)
  std::vector<float> vignette_inv;  // out_h*out_w 1/V (or empty)
};

// src (sw x sh) -> dst (out_w x out_h): bilinear remap (or plain crop when no
// remap table), then gamma LUT + vignette division — single pass per pixel.
void postprocess(const std::vector<float>& src, int sw, int sh, float* dst,
                 const Calibration& c) {
  const bool remap = !c.remap_x.empty();
  const bool gamma = !c.gamma.empty();
  const bool vig = !c.vignette_inv.empty();
  for (int y = 0; y < c.out_h; y++) {
    for (int x = 0; x < c.out_w; x++) {
      const size_t o = size_t(y) * c.out_w + x;
      float v;
      if (remap) {
        const float fx = c.remap_x[o], fy = c.remap_y[o];
        if (fx < 0.f || fy < 0.f || fx >= sw - 1 || fy >= sh - 1) {
          v = 0.f;
        } else {
          const int ix = int(fx), iy = int(fy);
          const float ax = fx - ix, ay = fy - iy;
          const float* p = src.data() + size_t(iy) * sw + ix;
          v = (1 - ay) * ((1 - ax) * p[0] + ax * p[1]) +
              ay * ((1 - ax) * p[sw] + ax * p[sw + 1]);
        }
      } else {
        v = (y < sh && x < sw) ? src[size_t(y) * sw + x] : 0.f;
      }
      if (gamma) {
        int i = int(v);
        if (i < 0) i = 0;
        if (i > 255) i = 255;
        v = c.gamma[i];
      }
      if (vig) v *= c.vignette_inv[o];
      dst[o] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// prefetch pool
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<float> left, right;
  bool ready = false;
  bool failed = false;
};

struct Loader {
  std::vector<std::string> lpaths, rpaths;
  Calibration calib;
  int capacity = 8;

  std::vector<Slot> ring;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits on slot ready
  std::condition_variable cv_space;   // workers wait for ring space
  std::atomic<int> next_claim{0};
  int cursor = 0;  // next frame index the consumer will take
  bool stop = false;

  int n() const { return int(lpaths.size()); }

  void worker() {
    std::vector<float> buf;
    for (;;) {
      const int idx = next_claim.fetch_add(1);
      if (idx >= n()) return;
      // bound the readahead: wait until idx is within [cursor, cursor+cap)
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return stop || idx < cursor + capacity; });
        if (stop) return;
      }
      Slot& s = ring[idx % capacity];
      s.failed = false;
      int w = 0, h = 0;
      const size_t px = size_t(calib.out_w) * calib.out_h;
      s.left.resize(px);
      s.right.resize(px);
      if (decode_gray(lpaths[idx].c_str(), buf, &w, &h))
        postprocess(buf, w, h, s.left.data(), calib);
      else
        s.failed = true;
      if (decode_gray(rpaths[idx].c_str(), buf, &w, &h))
        postprocess(buf, w, h, s.right.data(), calib);
      else
        s.failed = true;
      {
        std::lock_guard<std::mutex> lk(mu);
        s.ready = true;
      }
      cv_ready.notify_all();
    }
  }

  int take(float* out_l, float* out_r) {
    if (cursor >= n()) return -1;
    Slot& s = ring[cursor % capacity];
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_ready.wait(lk, [&] { return s.ready; });
    }
    const int idx = cursor;
    const int rc = s.failed ? -2 : idx;
    const size_t bytes = sizeof(float) * size_t(calib.out_w) * calib.out_h;
    std::memcpy(out_l, s.left.data(), bytes);
    std::memcpy(out_r, s.right.data(), bytes);
    {
      std::lock_guard<std::mutex> lk(mu);
      s.ready = false;
      cursor = idx + 1;
    }
    cv_space.notify_all();
    return rc;
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_space.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

}  // namespace

extern "C" {

// One-shot decode into caller buffer (cap floats); returns 0 on success.
int sdso_decode_gray(const char* path, float* out, long cap, int* w, int* h) {
  std::vector<float> buf;
  if (!decode_gray(path, buf, w, h)) return -1;
  if (long(buf.size()) > cap) return -2;
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 0;
}

void* sdso_loader_open(const char** left_paths, const char** right_paths,
                       int n_frames, int n_workers, int capacity, int out_w,
                       int out_h, const float* remap_x, const float* remap_y,
                       const float* gamma_lut, const float* vignette_inv) {
  auto* L = new Loader();
  L->lpaths.assign(left_paths, left_paths + n_frames);
  L->rpaths.assign(right_paths, right_paths + n_frames);
  L->calib.out_w = out_w;
  L->calib.out_h = out_h;
  const size_t px = size_t(out_w) * out_h;
  if (remap_x && remap_y) {
    L->calib.remap_x.assign(remap_x, remap_x + px);
    L->calib.remap_y.assign(remap_y, remap_y + px);
  }
  if (gamma_lut) L->calib.gamma.assign(gamma_lut, gamma_lut + 256);
  if (vignette_inv)
    L->calib.vignette_inv.assign(vignette_inv, vignette_inv + px);
  if (capacity < 2) capacity = 2;
  L->capacity = capacity;
  L->ring.resize(capacity);
  if (n_workers < 1) n_workers = 1;
  for (int i = 0; i < n_workers; i++)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Blocking in-order fetch. Returns the frame index, -1 at end of sequence,
// -2 if decoding that frame failed (buffers zero-filled).
int sdso_loader_next(void* handle, float* out_left, float* out_right) {
  return static_cast<Loader*>(handle)->take(out_left, out_right);
}

void sdso_loader_close(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
