// eovax_torch native data-path kernels, a copy of eovax/native/blosc.cc:
// blosc1 frame decoding (LZ4 + blosclz + memcpy codecs), byte-shuffle undo,
// and raw LZ4 block decompression.
//
// The TerraMesh shards are tar archives of zip-zarr groups whose chunks are
// blosc-compressed (zarr's default numcodecs.Blosc). The reference decodes
// them through the Python zarr/numcodecs stack inside DataLoader worker
// processes; here the hot byte-level work is native C++ driven from the
// streaming reader threads (eovax_torch/data/zarrzip.py) via ctypes.
//
// Implemented from the public c-blosc format documentation
// (https://github.com/Blosc/c-blosc/blob/main/README_HEADER_FORMAT.rst):
//   16-byte header: version, versionlz, flags, typesize,
//                   nbytes, blocksize, cbytes (int32 LE each)
//   flags: bit0 byte-shuffle, bit1 pure-memcpy, bit2 bit-shuffle,
//          bits 5-7 codec (0 blosclz, 1 lz4/lz4hc, 3 zlib, 4 zstd)
//   body (non-memcpy): int32 bstarts[nblocks], then per block either one
//   compressed stream or `typesize` split streams, each prefixed with an
//   int32 compressed size; a negative/equal size marks a verbatim stream.
//
// Build: g++ -O3 -shared -fPIC (see eovax_torch/native/__init__.py).

#include <cstdint>
#include <cstring>

namespace {

inline int32_t read_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/ARM)
}

}  // namespace

extern "C" {

// LZ4 block decompression. Returns decompressed size or -1 on error.
int eovax_lz4_decompress(const uint8_t* src, int src_len, uint8_t* dst,
                         int dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  while (ip < iend) {
    const uint8_t token = *ip++;
    // Literals.
    int lit_len = token >> 4;
    if (lit_len == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        lit_len += s;
      } while (s == 255);
    }
    if (ip + lit_len > iend || op + lit_len > oend) return -1;
    std::memcpy(op, ip, lit_len);
    ip += lit_len;
    op += lit_len;
    if (ip >= iend) break;  // last token has no match part

    // Match.
    if (ip + 2 > iend) return -1;
    const int offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int match_len = (token & 0x0F);
    if (match_len == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        match_len += s;
      } while (s == 255);
    }
    match_len += 4;
    if (op + match_len > oend) return -1;
    const uint8_t* mp = op - offset;
    // Overlapping copy must be byte-by-byte.
    for (int i = 0; i < match_len; ++i) op[i] = mp[i];
    op += match_len;
  }
  return static_cast<int>(op - dst);
}

// blosclz decompression (c-blosc's default codec). Returns size or -1.
int eovax_blosclz_decompress(const uint8_t* src, int src_len, uint8_t* dst,
                             int dst_cap) {
  // Format: first byte = flags (bits 0-4: version/hash log unused here).
  // Stream of ops: ctrl byte c:
  //   c < 32 → literal run of c+1 bytes
  //   else   → match: len = c >> 5, distance high = c & 31
  //            len == 7 → extended by following 255-terminated bytes
  //            then one byte distance low; distance == 0xFFFF+? long match
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  if (ip >= iend) return -1;
  ++ip;  // skip the initial token/version byte

  // First op is always a literal run.
  bool first = true;
  while (ip < iend) {
    uint32_t ctrl = *ip++;
    if (first || ctrl < 32) {
      uint32_t run = (ctrl & 31) + 1;
      if (first && ctrl >= 32) return -1;
      if (ip + run > iend || op + run > oend) return -1;
      std::memcpy(op, ip, run);
      ip += run;
      op += run;
      first = false;
      continue;
    }
    uint32_t len = (ctrl >> 5) + 2;
    uint32_t dist = (ctrl & 31) << 8;
    if (len == 7 + 2) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        len += s;
      } while (s == 255);
    }
    if (ip >= iend) return -1;
    dist += *ip++;
    if (dist == 8191) {  // long-distance match: two extra bytes
      if (ip + 2 > iend) return -1;
      dist += (ip[0] << 8) | ip[1];
      ip += 2;
    }
    const uint8_t* mp = op - dist - 1;
    if (mp < dst || op + len > oend) return -1;
    for (uint32_t i = 0; i < len; ++i) op[i] = mp[i];
    op += len;
  }
  return static_cast<int>(op - dst);
}

// Undo blosc byte-shuffle: src holds `typesize` planes of n/typesize bytes.
void eovax_unshuffle(int typesize, long n, const uint8_t* src, uint8_t* dst) {
  if (typesize <= 1) {
    std::memcpy(dst, src, n);
    return;
  }
  const long elems = n / typesize;
  if (typesize == 4) {
    // Hot path (fp32/int32 bands): 4 sequential read streams packed into
    // one sequential uint32 write stream — auto-vectorizes under -O3 and
    // runs near memcpy speed (the generic strided loop re-touches every
    // destination cache line `typesize` times).
    const uint8_t* s0 = src;
    const uint8_t* s1 = src + elems;
    const uint8_t* s2 = src + 2 * elems;
    const uint8_t* s3 = src + 3 * elems;
    for (long i = 0; i < elems; ++i) {
      const uint32_t v = static_cast<uint32_t>(s0[i]) |
                         (static_cast<uint32_t>(s1[i]) << 8) |
                         (static_cast<uint32_t>(s2[i]) << 16) |
                         (static_cast<uint32_t>(s3[i]) << 24);
      std::memcpy(dst + 4 * i, &v, 4);
    }
  } else {
  for (int t = 0; t < typesize; ++t) {
    const uint8_t* s = src + t * elems;
    uint8_t* d = dst + t;
    for (long i = 0; i < elems; ++i) {
      *d = s[i];
      d += typesize;
    }
  }
  }
  // Trailing bytes (n not divisible by typesize) are stored verbatim.
  const long tail = n - elems * typesize;
  if (tail) std::memcpy(dst + elems * typesize, src + elems * typesize, tail);
}

// Full blosc1 frame decode. Returns nbytes or negative error code:
//  -1 malformed, -2 unsupported codec, -3 buffer too small.
long eovax_blosc_decompress(const uint8_t* src, long src_len, uint8_t* dst,
                            long dst_cap) {
  if (src_len < 16) return -1;
  const uint8_t flags = src[2];
  const int typesize = src[3];
  const long nbytes = read_i32(src + 4);
  const long blocksize = read_i32(src + 8);
  const long cbytes = read_i32(src + 12);
  if (nbytes > dst_cap) return -3;
  if (cbytes > src_len) return -1;
  if (nbytes == 0) return 0;

  const bool byte_shuffle = flags & 0x1;
  const bool memcpyed = flags & 0x2;
  const bool bit_shuffle = flags & 0x4;
  const int codec = (flags >> 5) & 0x7;
  if (bit_shuffle) return -2;  // bit-shuffle not needed for these datasets

  if (memcpyed) {
    if (16 + nbytes > src_len) return -1;
    std::memcpy(dst, src + 16, nbytes);
    return nbytes;
  }

  const long nblocks = (nbytes + blocksize - 1) / blocksize;
  const uint8_t* bstarts = src + 16;
  if (16 + 4 * nblocks > src_len) return -1;

  // Split-stream rule (c-blosc split_block): blosclz & lz4 with
  // byte-shuffle split each block into `typesize` streams.
  const bool split =
      byte_shuffle && typesize > 1 && (codec == 0 || codec == 1) &&
      (blocksize / typesize) >= 32;

  // Scratch for one decompressed (still-shuffled) block.
  static thread_local uint8_t* scratch = nullptr;
  static thread_local long scratch_cap = 0;
  if (blocksize > scratch_cap) {
    delete[] scratch;
    scratch = new uint8_t[blocksize];
    scratch_cap = blocksize;
  }

  for (long b = 0; b < nblocks; ++b) {
    const long boff = read_i32(bstarts + 4 * b);
    if (boff < 0 || boff >= src_len) return -1;
    const long out_off = b * blocksize;
    const long block_out = (out_off + blocksize <= nbytes)
                               ? blocksize
                               : (nbytes - out_off);
    uint8_t* block_dst = byte_shuffle ? scratch : dst + out_off;

    const uint8_t* p = src + boff;
    const int nstreams = split ? typesize : 1;
    const long stream_out = block_out / nstreams;
    long produced = 0;
    for (int s = 0; s < nstreams; ++s) {
      if (p + 4 > src + src_len) return -1;
      int32_t csize = read_i32(p);
      p += 4;
      const long want = (s == nstreams - 1) ? (block_out - produced)
                                            : stream_out;
      if (csize == 0) {
        // zeros run (rare)
        std::memset(block_dst + produced, 0, want);
      } else if (csize == want || csize < 0) {
        // verbatim stream
        const long n = csize < 0 ? -csize : csize;
        if (p + n > src + src_len || n != want) return -1;
        std::memcpy(block_dst + produced, p, n);
        p += n;
      } else {
        if (p + csize > src + src_len) return -1;
        int r;
        if (codec == 1) {
          r = eovax_lz4_decompress(p, csize, block_dst + produced,
                                   static_cast<int>(want));
        } else if (codec == 0) {
          r = eovax_blosclz_decompress(p, csize, block_dst + produced,
                                       static_cast<int>(want));
        } else {
          return -2;  // zlib/zstd handled at the Python layer
        }
        if (r != want) return -1;
        p += csize;
      }
      produced += want;
    }
    if (byte_shuffle) {
      eovax_unshuffle(typesize, block_out, scratch, dst + out_off);
    }
  }
  return nbytes;
}

}  // extern "C"
