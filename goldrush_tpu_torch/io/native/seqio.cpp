// Native FASTQ/FASTA block reader for host-side ingest.
//
// Plays the role of btllib::SeqReader LONG_MODE + the read-hashing producer
// pool's record handling (reference read_hashing.cpp:78-117): streams
// records from plain or gzip files, 2-bit-encodes bases, computes phred
// gate statistics, and fills caller-provided flat buffers so Python/JAX
// sees ready-to-use numpy arrays without per-record Python overhead.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
//
// Build: see build.py (g++ -O3 -shared -fPIC seqio.cpp -lz).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

struct Reader {
  gzFile gz = nullptr;
  std::string buf;       // carry-over for partial lines
  size_t pos = 0;        // cursor into buf
  bool eof = false;
  int format = 0;        // 0 unknown, 1 fastq, 2 fasta
  std::string pending_header;  // fasta: last seen header line

  bool fill() {
    if (eof) return false;
    char tmp[1 << 16];
    int n = gzread(gz, tmp, sizeof(tmp));
    if (n <= 0) {
      eof = true;
      return false;
    }
    buf.erase(0, pos);
    pos = 0;
    buf.append(tmp, n);
    return true;
  }

  // returns false at EOF; line excludes the trailing newline
  bool getline(std::string& line) {
    for (;;) {
      size_t nl = buf.find('\n', pos);
      if (nl != std::string::npos) {
        line.assign(buf, pos, nl - pos);
        pos = nl + 1;
        return true;
      }
      if (!fill()) {
        if (pos < buf.size()) {
          line.assign(buf, pos, buf.size() - pos);
          pos = buf.size();
          return true;
        }
        return false;
      }
    }
  }
};

int8_t g_encode[256];

struct EncodeInit {
  EncodeInit() {
    memset(g_encode, -1, sizeof(g_encode));
    const char* b = "ACGT";
    const char* bl = "acgt";
    for (int i = 0; i < 4; ++i) {
      g_encode[(uint8_t)b[i]] = i;
      g_encode[(uint8_t)bl[i]] = i;
    }
  }
} g_encode_init;

double g_delog[256];
struct DelogInit {
  DelogInit() {
    for (int q = 0; q < 256; ++q)
      g_delog[q] = pow(10.0, -(double)(q - 33) / 10.0);
  }
} g_delog_init;

}  // namespace

extern "C" {

void* seqio_open(const char* path) {
  gzFile gz = gzopen(path, "rb");
  if (!gz) return nullptr;
  gzbuffer(gz, 1 << 20);
  Reader* r = new Reader();
  r->gz = gz;
  return r;
}

void seqio_close(void* h) {
  Reader* r = (Reader*)h;
  if (r) {
    gzclose(r->gz);
    delete r;
  }
}

// Read up to max_records records.  Caller provides flat output buffers:
//  seq_buf[seq_cap]      raw bases (records appended back to back)
//  code_buf[seq_cap]     2-bit codes (255 = invalid base)
//  qual_buf[seq_cap]     raw quality bytes (fastq only; zeroed for fasta)
//  offsets[max_records+1] start offset of each record in seq_buf
//  name_buf[name_cap]    record IDs, '\0'-separated
//  phred_avg/phred_delta[max_records]  int32 gate stats
//     (avg = trunc(-10*log10(mean delog)); delta as calc_phred_average.cpp)
//  invalid[max_records]  1 if any non-ACGT base
// Returns number of records read (0 = EOF); -1 on error; -2 if a record
// would overflow seq_buf (caller should retry with bigger buffer; stream
// position is unchanged for the overflowing record).
int64_t seqio_read_block(void* h, int64_t max_records, uint8_t* seq_buf,
                         uint8_t* code_buf, uint8_t* qual_buf,
                         int64_t seq_cap, int64_t* offsets, char* name_buf,
                         int64_t name_cap, int32_t* phred_avg,
                         int32_t* phred_delta, double* phred_sum,
                         uint8_t* invalid, int32_t* fmt_out) {
  Reader* r = (Reader*)h;
  int64_t n = 0;
  int64_t off = 0;
  int64_t name_off = 0;
  offsets[0] = 0;
  std::string line, seq, qual;
  while (n < max_records) {
    // detect / read one record
    if (r->format == 0) {
      if (!r->getline(line)) break;
      if (line.empty()) continue;
      if (line[0] == '@') r->format = 1;
      else if (line[0] == '>') r->format = 2;
      else return -1;
      r->pending_header = line;
    } else if (r->format == 1 || r->pending_header.empty()) {
      if (!r->getline(line)) break;
      if (line.empty()) continue;
      r->pending_header = line;
    }
    std::string header = r->pending_header;
    r->pending_header.clear();
    if (r->format == 1) {
      if (header.empty() || header[0] != '@') return -1;
      if (!r->getline(seq)) return -1;
      if (!r->getline(line)) return -1;  // '+'
      if (!r->getline(qual)) return -1;
    } else {
      if (header.empty() || header[0] != '>') return -1;
      seq.clear();
      for (;;) {
        if (!r->getline(line)) break;
        if (!line.empty() && line[0] == '>') {
          r->pending_header = line;
          break;
        }
        seq += line;
      }
      qual.clear();
    }
    int64_t len = (int64_t)seq.size();
    if (off + len > seq_cap) return n > 0 ? n : -2;
    // name: first whitespace token after the marker
    size_t ws = header.find_first_of(" \t");
    size_t name_len = (ws == std::string::npos ? header.size() : ws) - 1;
    if (name_off + (int64_t)name_len + 1 > name_cap) return n > 0 ? n : -2;
    memcpy(name_buf + name_off, header.data() + 1, name_len);
    name_buf[name_off + name_len] = '\0';
    name_off += name_len + 1;

    memcpy(seq_buf + off, seq.data(), len);
    uint8_t inv = 0;
    for (int64_t i = 0; i < len; ++i) {
      int8_t c = g_encode[(uint8_t)seq[i]];
      code_buf[off + i] = (uint8_t)c;
      inv |= (c < 0);
    }
    invalid[n] = inv;
    if (r->format == 1 && (int64_t)qual.size() == len && len > 0) {
      memcpy(qual_buf + off, qual.data(), len);
      double sum = 0.0, first = 0.0;
      int64_t half = len / 2;
      for (int64_t i = 0; i < len; ++i) {
        sum += g_delog[(uint8_t)qual[i]];
        if (i == half - 1) first = sum;
      }
      double second = sum - first;
      phred_sum[n] = sum;
      phred_avg[n] = (int32_t)(-10.0 * log10(sum / (double)len));
      int32_t d1 = (int32_t)(-10.0 * log10(first / (len * 0.5)));
      int32_t d2 = (int32_t)(-10.0 * log10(second / (len * 0.5)));
      phred_delta[n] = d1 > d2 ? d1 - d2 : d2 - d1;
    } else {
      if (len > 0) memset(qual_buf + off, 0, len);
      phred_avg[n] = 0;
      phred_delta[n] = 0;
      phred_sum[n] = 0.0;
    }
    off += len;
    ++n;
    offsets[n] = off;
  }
  *fmt_out = r->format;
  return n;
}

}  // extern "C"
