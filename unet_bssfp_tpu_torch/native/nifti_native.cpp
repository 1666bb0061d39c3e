// Native NIfTI-1 codec: header parse + zlib (de)compression + dtype
// conversion to float32, callable from Python via ctypes (the port's own
// copy of unet_bssfp_tpu/native/nifti_native.cpp).
//
// Role: the data-loader hot path. The reference delegates NIfTI IO to
// nibabel's C extensions inside 8 TorchIO worker processes
// (src/data_module.py:152-166); here a single ctypes call does the full
// read→decode→float32 conversion in native code with the GIL released, so a
// small thread pool saturates disk + decompression without process fan-out.
//
// Its results are those of the port's pure-Python codec
// (unet_bssfp_tpu_torch/data/nifti.py) bit for bit: scl_slope/scl_inter are
// applied by that codec's rule (not at a zero or NaN slope, nor at slope 1
// with intercept 0) as two float roundings, which is why it is built with
// -ffp-contract=off; uint32 data is read as well; and it writes the same
// header (sform_code 1 at byte 254, qform_code 0).
//
// Build: g++ -O3 -shared -fPIC -ffp-contract=off nifti_native.cpp -o
//        <lib>.so -lz (driven by unet_bssfp_tpu_torch/native/__init__.py,
//        into unet_bssfp_tpu_torch/_build/)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

constexpr int kHdrSize = 348;
constexpr uint32_t kChunk = 1 << 20;

#pragma pack(push, 1)
struct NiftiHeader {
  int32_t sizeof_hdr;        // 0
  char pad0[36];             // 4..39
  int16_t dim[8];            // 40
  char pad1[14];             // 56..69
  int16_t datatype;          // 70
  int16_t bitpix;            // 72
  int16_t slice_start;       // 74
  float pixdim[8];           // 76
  float vox_offset;          // 108
  float scl_slope;           // 112
  float scl_inter;           // 116
  char pad2[132];            // 120..251
  int16_t qform_code;        // 252
  int16_t sform_code;        // 254
  char pad3[24];             // 256..279
  float srow[12];            // 280
  char intent_name[16];      // 328
  char magic[4];             // 344
};
#pragma pack(pop)

static_assert(sizeof(NiftiHeader) == kHdrSize, "header layout");

// Read an entire file; transparently inflates gzip (zlib handles both).
bool ReadAll(const char* path, std::vector<uint8_t>* out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  gzbuffer(f, kChunk);
  out->clear();
  size_t cap = 4 * kChunk;
  out->reserve(cap);
  std::vector<uint8_t> buf(kChunk);
  int n;
  while ((n = gzread(f, buf.data(), kChunk)) > 0) {
    out->insert(out->end(), buf.data(), buf.data() + n);
  }
  bool ok = (n == 0);
  gzclose(f);
  return ok;
}

template <typename T>
void ConvertTo32(const uint8_t* src, float* dst, int64_t count, float slope,
                 float inter) {
  const T* s = reinterpret_cast<const T*>(src);
  if (slope == 0.0f || std::isnan(slope) || (slope == 1.0f && inter == 0.0f)) {
    for (int64_t i = 0; i < count; ++i) dst[i] = static_cast<float>(s[i]);
  } else {
    for (int64_t i = 0; i < count; ++i)
      dst[i] = static_cast<float>(s[i]) * slope + inter;
  }
}

}  // namespace

extern "C" {

// Parse header only: fills dims[8] (dim[0]=ndim) and affine[12] (srow).
// Returns 0 on success.
int nifti_read_header(const char* path, int64_t* dims, double* affine,
                      int* datatype) {
  gzFile f = gzopen(path, "rb");
  if (!f) return 1;
  NiftiHeader hdr;
  int n = gzread(f, &hdr, kHdrSize);
  gzclose(f);
  if (n != kHdrSize || hdr.sizeof_hdr != kHdrSize) return 2;
  for (int i = 0; i < 8; ++i) dims[i] = hdr.dim[i];
  for (int i = 0; i < 12; ++i) affine[i] = hdr.srow[i];
  *datatype = hdr.datatype;
  return 0;
}

// Full read: decompress, convert to float32 into caller buffer of
// `capacity` elements. Returns number of elements, or -errno.
int64_t nifti_read_f32(const char* path, float* out, int64_t capacity,
                       int64_t* dims, double* affine) {
  std::vector<uint8_t> raw;
  if (!ReadAll(path, &raw)) return -1;
  if (raw.size() < kHdrSize) return -2;
  NiftiHeader hdr;
  std::memcpy(&hdr, raw.data(), kHdrSize);
  if (hdr.sizeof_hdr != kHdrSize) return -3;  // big-endian unsupported here

  int ndim = hdr.dim[0];
  if (ndim < 1 || ndim > 7) return -4;
  int64_t count = 1;
  for (int i = 0; i < 8; ++i) dims[i] = hdr.dim[i];
  for (int i = 1; i <= ndim; ++i) count *= hdr.dim[i];
  if (count > capacity) return -5;
  for (int i = 0; i < 12; ++i) affine[i] = hdr.srow[i];

  size_t offset = static_cast<size_t>(hdr.vox_offset);
  if (offset < kHdrSize) offset = kHdrSize + 4;
  if (raw.size() < offset) return -6;
  const uint8_t* data = raw.data() + offset;
  size_t avail = raw.size() - offset;
  float slope = hdr.scl_slope, inter = hdr.scl_inter;

  switch (hdr.datatype) {
    case 2:  // uint8
      if (avail < (size_t)count) return -7;
      ConvertTo32<uint8_t>(data, out, count, slope, inter);
      break;
    case 4:  // int16
      if (avail < (size_t)count * 2) return -7;
      ConvertTo32<int16_t>(data, out, count, slope, inter);
      break;
    case 8:  // int32
      if (avail < (size_t)count * 4) return -7;
      ConvertTo32<int32_t>(data, out, count, slope, inter);
      break;
    case 16:  // float32
      if (avail < (size_t)count * 4) return -7;
      ConvertTo32<float>(data, out, count, slope, inter);
      break;
    case 64:  // float64
      if (avail < (size_t)count * 8) return -7;
      ConvertTo32<double>(data, out, count, slope, inter);
      break;
    case 256:  // int8
      if (avail < (size_t)count) return -7;
      ConvertTo32<int8_t>(data, out, count, slope, inter);
      break;
    case 512:  // uint16
      if (avail < (size_t)count * 2) return -7;
      ConvertTo32<uint16_t>(data, out, count, slope, inter);
      break;
    case 768:  // uint32
      if (avail < (size_t)count * 4) return -7;
      ConvertTo32<uint32_t>(data, out, count, slope, inter);
      break;
    default:
      return -8;
  }
  return count;
}

// Write float32 data as NIfTI-1 (.nii or .nii.gz by extension).
// dims: [ndim, d1..d7]; affine: 12 doubles (srow). Returns 0 on success.
int nifti_write_f32(const char* path, const float* data, const int64_t* dims,
                    const double* affine) {
  NiftiHeader hdr;
  std::memset(&hdr, 0, sizeof(hdr));
  hdr.sizeof_hdr = kHdrSize;
  int ndim = static_cast<int>(dims[0]);
  if (ndim < 1 || ndim > 7) return 1;
  int64_t count = 1;
  for (int i = 0; i < 8; ++i) hdr.dim[i] = 1;
  hdr.dim[0] = ndim;
  for (int i = 1; i <= ndim; ++i) {
    hdr.dim[i] = static_cast<int16_t>(dims[i]);
    count *= dims[i];
  }
  hdr.datatype = 16;  // float32
  hdr.bitpix = 32;
  for (int i = 0; i < 8; ++i) hdr.pixdim[i] = 1.0f;
  hdr.vox_offset = 352.0f;
  hdr.scl_slope = 1.0f;
  hdr.sform_code = 1;
  for (int i = 0; i < 12; ++i) hdr.srow[i] = static_cast<float>(affine[i]);
  std::memcpy(hdr.magic, "n+1", 4);

  size_t len = std::strlen(path);
  bool gz = len > 3 && std::strcmp(path + len - 3, ".gz") == 0;

  if (gz) {
    gzFile f = gzopen(path, "wb1");  // level 1: fast, NIfTI data compresses ok
    if (!f) return 2;
    gzbuffer(f, kChunk);
    bool ok = gzwrite(f, &hdr, kHdrSize) == kHdrSize;
    uint32_t zero = 0;
    ok = ok && gzwrite(f, &zero, 4) == 4;
    int64_t remaining = count * 4;
    const char* p = reinterpret_cast<const char*>(data);
    while (ok && remaining > 0) {
      unsigned chunk = remaining > kChunk ? kChunk : (unsigned)remaining;
      ok = gzwrite(f, p, chunk) == (int)chunk;
      p += chunk;
      remaining -= chunk;
    }
    gzclose(f);
    return ok ? 0 : 3;
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  bool ok = std::fwrite(&hdr, 1, kHdrSize, f) == kHdrSize;
  uint32_t zero = 0;
  ok = ok && std::fwrite(&zero, 1, 4, f) == 4;
  ok = ok && std::fwrite(data, 4, count, f) == (size_t)count;
  std::fclose(f);
  return ok ? 0 : 3;
}

}  // extern "C"
