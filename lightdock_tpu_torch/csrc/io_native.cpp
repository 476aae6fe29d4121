// Host IO library of lightdock_tpu_torch: the PDB reader and the gso_N.out
// writer, with a plain C interface loaded through ctypes
// (lightdock_tpu_torch/utils/native.py).  It is built with the host C++
// compiler at first use (ops/_build.py) and runs on the CPU only.
//
// The port's own copy of lightdock_tpu/native/io_native.cpp.  The Python
// versions stay beside it as its plain versions (utils/pdb.py
// parse_pdb_plain, utils/output.py format_gso_output) and its output must
// equal theirs byte for byte, but for a NaN whose sign bit is set (below).
//
// PDB fields follow utils/pdb.py: ATOM/HETATM records, columns 13-16 atom
// name, 18-20 residue name, 22 chain id, 23-26 residue serial, 27
// insertion code, 31-54 coordinates; res_id is
// "{chain}.{resname}.{serial}{icode}".
//
// gso_N.out follows utils/output.py (reference format src/swarm.rs:128-167):
// "%.7f" pose components, the literal "    0    0   ", "%.8f" luciferin,
// the neighbour count, "%.3f" vision, "%.8f" scoring.  Unlike the JAX
// package's copy, which calls fprintf for every number, a finite value
// below 2^32 is rendered from its exact binary value with integer
// arithmetic (round half to even on the exact value, as Python's
// format() and glibc's printf both do), the whole file in one buffer and
// one fwrite; anything else goes to snprintf.  A NaN is written "-nan"
// where its sign bit is set and "nan" otherwise, as glibc's printf writes
// it in the JAX package's copy (Python writes "nan" for both).

#include <cerrno>
#include <cctype>
#include <cinttypes>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

namespace {

struct PdbData {
  std::vector<double> coords;  // (n, 3) row-major
  // Columns joined with \x1f separators (ASCII unit separator).
  std::string atom_names;
  std::string res_names;
  std::string res_ids;
  std::string chain_ids;
  int64_t natoms = 0;
  int64_t bad_line = 0;  // 1-based line of the first unreadable coordinate
};

std::string strip(const std::string& s) {
  size_t a = 0, b = s.size();
  while (a < b && std::isspace(static_cast<unsigned char>(s[a]))) ++a;
  while (b > a && std::isspace(static_cast<unsigned char>(s[b - 1]))) --b;
  return s.substr(a, b - a);
}

void append_col(std::string* col, const std::string& v, bool first) {
  if (!first) col->push_back('\x1f');
  col->append(v);
}

// A coordinate field as Python's float() reads it: a number with blanks
// around it and nothing else.
bool read_coord(const std::string& field, double* out) {
  const char* start = field.c_str();
  char* end = nullptr;
  *out = std::strtod(start, &end);
  if (end == start) return false;
  while (*end != '\0' && std::isspace(static_cast<unsigned char>(*end))) ++end;
  return *end == '\0';
}

constexpr uint64_t pow10(int d) { return d == 0 ? 1 : 10 * pow10(d - 1); }

// Append the decimal digits of n, at least min_digits of them (leading
// zeros), with one append.
void put_uint(std::string* out, uint64_t n, int min_digits) {
  char tmp[24];
  char* end = tmp + sizeof tmp;
  char* p = end;
  do {
    *--p = static_cast<char>('0' + n % 10);
    n /= 10;
  } while (n != 0 || end - p < min_digits);
  out->append(p, static_cast<size_t>(end - p));
}

// Append v with D (0-9) digits after the point, as "%.*f" and Python's
// f"{v:.{D}f}" render it.  D is a template argument so every division by
// a power of ten is by a constant.
template <int D>
void put_fixed(std::string* out, double v) {
  static_assert(D >= 0 && D <= 9, "0 to 9 decimals");
  if (std::isnan(v)) {
    out->append(std::signbit(v) ? "-nan" : "nan");
    return;
  }
  const double a = std::fabs(v);
  if (!(a < 4294967296.0)) {  // inf, or too large for the integer path
    char buf[400];
    std::snprintf(buf, sizeof buf, "%.*f", D, v);
    out->append(buf);
    return;
  }
  if (std::signbit(v)) out->push_back('-');
  uint64_t n = 0;  // round(a * 10^D), half to even, exactly
  if (a != 0.0) {
    uint64_t bits;
    std::memcpy(&bits, &a, sizeof bits);
    const int biased = static_cast<int>(bits >> 52);
    uint64_t mant = bits & ((1ull << 52) - 1);
    int e;  // a = mant * 2^e
    if (biased == 0) {
      e = -1074;
    } else {
      mant |= 1ull << 52;
      e = biased - 1075;
    }
    // a < 2^32 gives e <= -21 for a normal a (mant >= 2^52), and a
    // subnormal has e = -1074: the exact value is p / 2^s with s = -e.
    const unsigned __int128 p = static_cast<unsigned __int128>(mant) * pow10(D);  // < 2^83
    const int s = -e;
    if (s < 100) {
      unsigned __int128 q = p >> s;
      const unsigned __int128 r = p - (q << s);
      const unsigned __int128 half = static_cast<unsigned __int128>(1) << (s - 1);
      if (r > half || (r == half && (q & 1))) ++q;
      n = static_cast<uint64_t>(q);
    }  // else p / 2^s < 2^-16: rounds to 0
  }
  put_uint(out, n / pow10(D), 1);
  if (D > 0) {
    out->push_back('.');
    put_uint(out, n % pow10(D), D);
  }
}

}  // namespace

extern "C" {

// Parse a PDB file; returns an opaque handle, or nullptr when the file
// cannot be opened.  Reading stops at the first atom record whose
// coordinates cannot be read (ld_pdb_bad_line names it).
void* ld_parse_pdb(const char* path) {
  std::ifstream in(path);
  if (!in) return nullptr;
  auto* data = new PdbData();
  std::string line;
  int64_t line_no = 0;
  while (std::getline(in, line)) {
    ++line_no;
    if (line.size() < 6) continue;
    const bool atom = line.compare(0, 6, "ATOM  ") == 0;
    const bool het = line.compare(0, 6, "HETATM") == 0;
    if (!atom && !het) continue;
    // Pad short lines so fixed-column slicing is safe.
    if (line.size() < 54) line.resize(54, ' ');
    const std::string atom_name = strip(line.substr(12, 4));
    const std::string res_name = strip(line.substr(17, 3));
    const std::string chain_id = strip(line.substr(21, 1));
    const std::string res_serial = strip(line.substr(22, 4));
    const std::string icode = strip(line.substr(26, 1));
    double x, y, z;
    if (!read_coord(line.substr(30, 8), &x) || !read_coord(line.substr(38, 8), &y) ||
        !read_coord(line.substr(46, 8), &z)) {
      data->bad_line = line_no;
      break;
    }
    const bool first = data->natoms == 0;
    append_col(&data->atom_names, atom_name, first);
    append_col(&data->res_names, res_name, first);
    append_col(&data->res_ids,
               chain_id + "." + res_name + "." + res_serial + icode, first);
    append_col(&data->chain_ids, chain_id, first);
    data->coords.push_back(x);
    data->coords.push_back(y);
    data->coords.push_back(z);
    ++data->natoms;
  }
  return data;
}

int64_t ld_pdb_bad_line(void* handle) {
  return static_cast<PdbData*>(handle)->bad_line;
}

int64_t ld_pdb_natoms(void* handle) {
  return static_cast<PdbData*>(handle)->natoms;
}

double* ld_pdb_coords(void* handle) {
  return static_cast<PdbData*>(handle)->coords.data();
}

// which: 0=atom_names 1=res_names 2=res_ids 3=chain_ids
const char* ld_pdb_strings(void* handle, int which) {
  auto* d = static_cast<PdbData*>(handle);
  switch (which) {
    case 0: return d->atom_names.c_str();
    case 1: return d->res_names.c_str();
    case 2: return d->res_ids.c_str();
    case 3: return d->chain_ids.c_str();
    default: return "";
  }
}

void ld_pdb_free(void* handle) { delete static_cast<PdbData*>(handle); }

// Write a gso_N.out snapshot.  Returns 0, or the errno of the failed open
// or write.
int ld_write_gso(const char* path, const double* poses, int64_t g,
                 int64_t pose_dim, const double* luciferin,
                 const int64_t* num_neighbors, const double* vision,
                 const double* scoring) {
  std::string text;
  text.reserve(static_cast<size_t>(96 + g * (pose_dim * 14 + 48)));
  text.append(
      "#Coordinates  RecID  LigID  Luciferin  Neighbor's number  Vision "
      "Range  Scoring\n");
  for (int64_t i = 0; i < g; ++i) {
    text.push_back('(');
    for (int64_t j = 0; j < pose_dim; ++j) {
      if (j) text.append(", ");
      put_fixed<7>(&text, poses[i * pose_dim + j]);
    }
    text.append(")    0    0   ");
    put_fixed<8>(&text, luciferin[i]);
    text.append("  ");
    const int64_t nn = num_neighbors[i];
    if (nn < 0) text.push_back('-');
    put_uint(&text, nn < 0 ? 0 - static_cast<uint64_t>(nn) : static_cast<uint64_t>(nn), 1);
    text.push_back(' ');
    put_fixed<3>(&text, vision[i]);
    text.push_back(' ');
    put_fixed<8>(&text, scoring[i]);
    text.push_back('\n');
  }
  FILE* f = std::fopen(path, "w");
  if (!f) return errno ? errno : EIO;
  const size_t written = std::fwrite(text.data(), 1, text.size(), f);
  const int write_errno = written == text.size() ? 0 : (errno ? errno : EIO);
  if (std::fclose(f) != 0 && write_errno == 0) return errno ? errno : EIO;
  return write_errno;
}

}  // extern "C"
