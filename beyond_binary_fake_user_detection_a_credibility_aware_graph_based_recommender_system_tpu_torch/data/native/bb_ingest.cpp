// Native JSONL ingest: streaming parse -> columnar interaction arrays.
//
// C++ replacement for the Python hot path of data/ingest.py (the reference
// parses >573K JSON lines in pure Python dict loops, lightgcn.py:120-145 /
// main.py:153-418; this is the dominant host-side cost of both stages).
// Single pass over the file:
//   * tolerant line-oriented JSON parsing (bad lines skipped, invalid UTF-8
//     replaced like Python's errors="replace");
//   * user/item interning in encounter order over valid records;
//   * md5("uid|iid")[:8]/0xFFFFFFFF content-hash split, bit-exact with the
//     reference algorithm (lightgcn.py:86-95);
//   * reference tokenizer [A-Za-z]+('[A-Za-z]+)? for per-record token /
//     unique-token counts, optional per-user corpus-level unique counts;
//   * all-records label counters (total / helpful_vote>5) per user.
//
// Exposed as a C ABI for ctypes (see ingest_native.py). No dependencies.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <string>
#include <vector>
#include <unordered_map>
#include <algorithm>

// ---------------------------------------------------------------------------
// MD5 (RFC 1321 algorithm, compact implementation)
// ---------------------------------------------------------------------------
namespace md5impl {

struct MD5 {
  uint32_t a0 = 0x67452301, b0 = 0xefcdab89, c0 = 0x98badcfe, d0 = 0x10325476;

  static uint32_t rotl(uint32_t x, int c) { return (x << c) | (x >> (32 - c)); }

  void process(const uint8_t* msg, size_t len, uint8_t digest[16]) {
    static const uint32_t K[64] = {
        0xd76aa478,0xe8c7b756,0x242070db,0xc1bdceee,0xf57c0faf,0x4787c62a,
        0xa8304613,0xfd469501,0x698098d8,0x8b44f7af,0xffff5bb1,0x895cd7be,
        0x6b901122,0xfd987193,0xa679438e,0x49b40821,0xf61e2562,0xc040b340,
        0x265e5a51,0xe9b6c7aa,0xd62f105d,0x02441453,0xd8a1e681,0xe7d3fbc8,
        0x21e1cde6,0xc33707d6,0xf4d50d87,0x455a14ed,0xa9e3e905,0xfcefa3f8,
        0x676f02d9,0x8d2a4c8a,0xfffa3942,0x8771f681,0x6d9d6122,0xfde5380c,
        0xa4beea44,0x4bdecfa9,0xf6bb4b60,0xbebfbc70,0x289b7ec6,0xeaa127fa,
        0xd4ef3085,0x04881d05,0xd9d4d039,0xe6db99e5,0x1fa27cf8,0xc4ac5665,
        0xf4292244,0x432aff97,0xab9423a7,0xfc93a039,0x655b59c3,0x8f0ccc92,
        0xffeff47d,0x85845dd1,0x6fa87e4f,0xfe2ce6e0,0xa3014314,0x4e0811a1,
        0xf7537e82,0xbd3af235,0x2ad7d2bb,0xeb86d391};
    static const int S[64] = {7,12,17,22,7,12,17,22,7,12,17,22,7,12,17,22,
                              5,9,14,20,5,9,14,20,5,9,14,20,5,9,14,20,
                              4,11,16,23,4,11,16,23,4,11,16,23,4,11,16,23,
                              6,10,15,21,6,10,15,21,6,10,15,21,6,10,15,21};

    std::vector<uint8_t> data(msg, msg + len);
    data.push_back(0x80);
    while (data.size() % 64 != 56) data.push_back(0);
    uint64_t bitlen = (uint64_t)len * 8;
    for (int i = 0; i < 8; i++) data.push_back((uint8_t)(bitlen >> (8 * i)));

    for (size_t off = 0; off < data.size(); off += 64) {
      uint32_t M[16];
      for (int i = 0; i < 16; i++)
        memcpy(&M[i], &data[off + 4 * i], 4);
      uint32_t A = a0, B = b0, C = c0, D = d0;
      for (int i = 0; i < 64; i++) {
        uint32_t F;
        int g;
        if (i < 16)      { F = (B & C) | (~B & D);        g = i; }
        else if (i < 32) { F = (D & B) | (~D & C);        g = (5 * i + 1) % 16; }
        else if (i < 48) { F = B ^ C ^ D;                 g = (3 * i + 5) % 16; }
        else             { F = C ^ (B | ~D);              g = (7 * i) % 16; }
        F = F + A + K[i] + M[g];
        A = D; D = C; C = B;
        B = B + rotl(F, S[i]);
      }
      a0 += A; b0 += B; c0 += C; d0 += D;
    }
    uint32_t out[4] = {a0, b0, c0, d0};
    memcpy(digest, out, 16);
  }
};

}  // namespace md5impl

// bucket: 0 train / 1 val / 2 test, identical to md5_split_bucket.
static int split_bucket(const std::string& uid, const std::string& iid,
                        double train_p, double val_p) {
  std::string s = uid + "|" + iid;
  uint8_t d[16];
  md5impl::MD5 m;
  m.process((const uint8_t*)s.data(), s.size(), d);
  // first 8 hex chars == first 4 bytes, big-endian hex string
  uint32_t v = ((uint32_t)d[0] << 24) | ((uint32_t)d[1] << 16) |
               ((uint32_t)d[2] << 8) | (uint32_t)d[3];
  double x = (double)v / (double)0xFFFFFFFFu;
  if (x < train_p) return 0;
  if (x < train_p + val_p) return 1;
  return 2;
}

// ---------------------------------------------------------------------------
// Minimal tolerant JSON value scanner
// ---------------------------------------------------------------------------
struct JsonField {
  bool present = false;
  bool is_string = false, is_number = false, is_bool = false;
  std::string str;
  double num = 0.0;
  bool bval = false;
};

struct LineParse {
  JsonField user, item, rating, timestamp, helpful, verified, title, text;
  bool ok = false;
};

static void skip_ws(const char*& p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) p++;
}

// Decode a JSON string into UTF-8; invalid \u pairs become U+FFFD.
static bool parse_json_string(const char*& p, const char* end, std::string* out) {
  if (p >= end || *p != '"') return false;
  p++;
  while (p < end) {
    unsigned char c = (unsigned char)*p;
    if (c == '"') { p++; return true; }
    if (c == '\\') {
      p++;
      if (p >= end) return false;
      char e = *p++;
      if (!out) continue;
      switch (e) {
        case 'n': out->push_back('\n'); break;
        case 't': out->push_back('\t'); break;
        case 'r': out->push_back('\r'); break;
        case 'b': out->push_back('\b'); break;
        case 'f': out->push_back('\f'); break;
        case '"': out->push_back('"'); break;
        case '\\': out->push_back('\\'); break;
        case '/': out->push_back('/'); break;
        case 'u': {
          if (end - p < 4) return false;
          unsigned int cp = 0;
          for (int i = 0; i < 4; i++) {
            char h = p[i];
            cp <<= 4;
            if (h >= '0' && h <= '9') cp |= h - '0';
            else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
            else return false;
          }
          p += 4;
          // surrogate pair
          if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 && p[0] == '\\' &&
              p[1] == 'u') {
            unsigned int lo = 0;
            bool okhex = true;
            for (int i = 0; i < 4; i++) {
              char h = p[2 + i];
              lo <<= 4;
              if (h >= '0' && h <= '9') lo |= h - '0';
              else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
              else { okhex = false; break; }
            }
            if (okhex && lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              p += 6;
            }
          }
          if (cp >= 0xD800 && cp <= 0xDFFF) cp = 0xFFFD;
          // encode UTF-8
          if (cp < 0x80) out->push_back((char)cp);
          else if (cp < 0x800) {
            out->push_back((char)(0xC0 | (cp >> 6)));
            out->push_back((char)(0x80 | (cp & 0x3F)));
          } else if (cp < 0x10000) {
            out->push_back((char)(0xE0 | (cp >> 12)));
            out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
            out->push_back((char)(0x80 | (cp & 0x3F)));
          } else {
            out->push_back((char)(0xF0 | (cp >> 18)));
            out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
            out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
            out->push_back((char)(0x80 | (cp & 0x3F)));
          }
          break;
        }
        default: return false;
      }
    } else {
      if (out) out->push_back((char)c);
      p++;
    }
  }
  return false;  // unterminated
}

static bool skip_value(const char*& p, const char* end);

static bool skip_container(const char*& p, const char* end, char open,
                           char close) {
  p++;  // consume open
  int depth = 1;
  while (p < end && depth > 0) {
    char c = *p;
    if (c == '"') {
      if (!parse_json_string(p, end, nullptr)) return false;
      continue;
    }
    if (c == open) depth++;
    else if (c == close) depth--;
    p++;
  }
  return depth == 0;
}

static bool parse_number(const char*& p, const char* end, double* out) {
  char* e = nullptr;
  double v = strtod(p, &e);
  if (e == p || e > end) return false;
  *out = v;
  p = e;
  return true;
}

static bool skip_value(const char*& p, const char* end) {
  skip_ws(p, end);
  if (p >= end) return false;
  char c = *p;
  if (c == '"') return parse_json_string(p, end, nullptr);
  if (c == '{') return skip_container(p, end, '{', '}');
  if (c == '[') return skip_container(p, end, '[', ']');
  if (c == 't') { if (end - p < 4 || strncmp(p, "true", 4)) return false; p += 4; return true; }
  if (c == 'f') { if (end - p < 5 || strncmp(p, "false", 5)) return false; p += 5; return true; }
  if (c == 'n') { if (end - p < 4 || strncmp(p, "null", 4)) return false; p += 4; return true; }
  double d;
  return parse_number(p, end, &d);
}

static bool parse_field_value(const char*& p, const char* end, JsonField* f) {
  skip_ws(p, end);
  if (p >= end) return false;
  char c = *p;
  f->present = true;
  if (c == '"') {
    f->is_string = true;
    return parse_json_string(p, end, &f->str);
  }
  if (c == 't') { f->is_bool = true; f->bval = true; p += 4; return true; }
  if (c == 'f') { f->is_bool = true; f->bval = false; p += 5; return true; }
  if (c == 'n') { f->present = false; p += 4; return true; }
  if (c == '{' || c == '[') { f->present = false; return skip_value(p, end); }
  f->is_number = true;
  return parse_number(p, end, &f->num);
}

// Parse one JSONL object line, capturing the fields of interest.
static bool parse_line(const char* p, const char* end, const char* user_key,
                       const char* item_key, const char* rating_key,
                       LineParse* out) {
  skip_ws(p, end);
  if (p >= end || *p != '{') return false;
  p++;
  size_t ulen = strlen(user_key), ilen = strlen(item_key),
         rlen = strlen(rating_key);
  while (true) {
    skip_ws(p, end);
    if (p < end && *p == '}') { out->ok = true; return true; }
    std::string key;
    if (!parse_json_string(p, end, &key)) return false;
    skip_ws(p, end);
    if (p >= end || *p != ':') return false;
    p++;
    JsonField* target = nullptr;
    if (key.size() == ulen && key == user_key) target = &out->user;
    else if (key.size() == ilen && key == item_key) target = &out->item;
    else if (key.size() == rlen && key == rating_key) target = &out->rating;
    else if (key == "timestamp") target = &out->timestamp;
    else if (key == "helpful_vote") target = &out->helpful;
    else if (key == "verified_purchase") target = &out->verified;
    else if (key == "title") target = &out->title;
    else if (key == "text") target = &out->text;

    if (target) {
      if (!parse_field_value(p, end, target)) return false;
    } else {
      if (!skip_value(p, end)) return false;
    }
    skip_ws(p, end);
    if (p < end && *p == ',') { p++; continue; }
    if (p < end && *p == '}') { out->ok = true; return true; }
    return false;
  }
}

// Replace invalid UTF-8 bytes with U+FFFD (Python errors="replace" shape).
static std::string utf8_replace(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  size_t i = 0, n = s.size();
  auto bad = [&out]() { out += "\xEF\xBF\xBD"; };
  while (i < n) {
    unsigned char c = (unsigned char)s[i];
    if (c < 0x80) { out.push_back((char)c); i++; continue; }
    int need = (c >= 0xF0) ? 3 : (c >= 0xE0) ? 2 : (c >= 0xC2) ? 1 : -1;
    if (need < 0) { bad(); i++; continue; }
    bool ok = i + need < n;
    for (int k = 1; ok && k <= need; k++)
      if (((unsigned char)s[i + k] & 0xC0) != 0x80) ok = false;
    if (ok) { out.append(s, i, need + 1); i += need + 1; }
    else { bad(); i++; }
  }
  return out;
}

// FNV-1a 64-bit
static uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; i++) {
    h ^= (unsigned char)s[i];
    h *= 1099511628211ull;
  }
  return h;
}

// Reference tokenizer: [A-Za-z]+('[A-Za-z]+)? lowercased.
// Appends token hashes to `hashes`.
static void tokenize_hashes(const std::string& text,
                            std::vector<uint64_t>* hashes) {
  size_t i = 0, n = text.size();
  std::string tok;
  while (i < n) {
    char c = text[i];
    if ((c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z')) {
      tok.clear();
      while (i < n) {
        char d = text[i];
        if (d >= 'A' && d <= 'Z') { tok.push_back((char)(d + 32)); i++; }
        else if (d >= 'a' && d <= 'z') { tok.push_back(d); i++; }
        else break;
      }
      // optional 'xxx tail
      if (i + 1 < n && text[i] == '\'') {
        char d = text[i + 1];
        if ((d >= 'A' && d <= 'Z') || (d >= 'a' && d <= 'z')) {
          tok.push_back('\'');
          i++;
          while (i < n) {
            char e2 = text[i];
            if (e2 >= 'A' && e2 <= 'Z') { tok.push_back((char)(e2 + 32)); i++; }
            else if (e2 >= 'a' && e2 <= 'z') { tok.push_back(e2); i++; }
            else break;
          }
        }
      }
      hashes->push_back(fnv1a(tok.data(), tok.size()));
    } else {
      i++;
    }
  }
}

// ---------------------------------------------------------------------------
// Result struct (C ABI)
// ---------------------------------------------------------------------------
extern "C" {

struct BBResult {
  int64_t n_records, n_users, n_items, bad_lines;
  int32_t* uidx;
  int32_t* iidx;
  float* rating;
  int64_t* timestamp;
  float* helpful;
  float* verified;
  int8_t* split;
  uint8_t* positive;
  int32_t* tok_count;
  int32_t* uniq_tok_count;
  char* user_id_blob;      int64_t* user_id_offsets;   // n_users+1
  char* item_id_blob;      int64_t* item_id_offsets;   // n_items+1
  int64_t* label_total;    // per user
  int64_t* label_helpful;  // per user
  int64_t* user_unique_tokens;  // per user, NULL unless requested
};

}  // extern "C" (reopened below for the entry points)

static char* blob_from(const std::vector<std::string>& v, int64_t** offsets) {
  int64_t total = 0;
  *offsets = (int64_t*)malloc(sizeof(int64_t) * (v.size() + 1));
  for (size_t i = 0; i < v.size(); i++) {
    (*offsets)[i] = total;
    total += (int64_t)v[i].size();
  }
  (*offsets)[v.size()] = total;
  char* blob = (char*)malloc(total ? total : 1);
  int64_t off = 0;
  for (auto& s : v) {
    memcpy(blob + off, s.data(), s.size());
    off += (int64_t)s.size();
  }
  return blob;
}

template <class T>
static T* arr_from(const std::vector<T>& v) {
  T* p = (T*)malloc(sizeof(T) * (v.size() ? v.size() : 1));
  memcpy(p, v.data(), sizeof(T) * v.size());
  return p;
}

extern "C" BBResult* bb_ingest(const char* path, const char* user_key,
                    const char* item_key, const char* rating_key,
                    double pos_threshold, double train_p, double val_p,
                    int with_text, int collect_tokens) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;

  std::unordered_map<std::string, int32_t> user2idx, item2idx;
  std::vector<std::string> user_ids, item_ids;
  std::unordered_map<std::string, std::pair<int64_t, int64_t>> label_counts;

  std::vector<int32_t> uidx, iidx, tokc, utokc;
  std::vector<float> rating, helpful, verified;
  std::vector<int64_t> ts;
  std::vector<int8_t> split;
  std::vector<uint8_t> positive;
  std::vector<uint64_t> user_tok_pairs_hi, user_tok_pairs_lo;  // uid, hash

  int64_t bad = 0;
  std::string line;
  std::vector<char> buf(1 << 20);
  std::vector<uint64_t> hashes;
  std::vector<uint64_t> tmp;

  while (fgets(buf.data(), (int)buf.size(), f)) {
    size_t len = strlen(buf.data());
    // handle very long lines
    line.assign(buf.data(), len);
    while (len > 0 && line.back() != '\n' && !feof(f)) {
      if (!fgets(buf.data(), (int)buf.size(), f)) break;
      len = strlen(buf.data());
      line.append(buf.data(), len);
    }
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    if (line.empty()) continue;

    LineParse lp;
    if (!parse_line(line.data(), line.data() + line.size(), user_key,
                    item_key, rating_key, &lp) || !lp.ok) {
      bad++;
      continue;
    }

    bool has_user = lp.user.present && lp.user.is_string;
    std::string uid;
    if (has_user) uid = utf8_replace(lp.user.str);

    if (has_user && !uid.empty()) {
      auto& lc = label_counts[uid];
      lc.first++;
      int64_t hv = 0;
      if (lp.helpful.present && lp.helpful.is_number)
        hv = (int64_t)lp.helpful.num;
      if (hv > 5) lc.second++;
    }

    double r = 0.0;
    bool has_rating = false;
    if (lp.rating.present) {
      if (lp.rating.is_number) { r = lp.rating.num; has_rating = true; }
      else if (lp.rating.is_string) {
        char* e = nullptr;
        r = strtod(lp.rating.str.c_str(), &e);
        has_rating = (e && *e == '\0' && !lp.rating.str.empty());
      }
    }
    bool has_item = lp.item.present && lp.item.is_string;
    if (!has_user || !has_item || !has_rating) continue;

    std::string iid = utf8_replace(lp.item.str);

    int32_t u;
    auto itu = user2idx.find(uid);
    if (itu == user2idx.end()) {
      u = (int32_t)user_ids.size();
      user2idx.emplace(uid, u);
      user_ids.push_back(uid);
    } else u = itu->second;

    int32_t it;
    auto iti = item2idx.find(iid);
    if (iti == item2idx.end()) {
      it = (int32_t)item_ids.size();
      item2idx.emplace(iid, it);
      item_ids.push_back(iid);
    } else it = iti->second;

    uidx.push_back(u);
    iidx.push_back(it);
    rating.push_back((float)r);
    ts.push_back(lp.timestamp.present && lp.timestamp.is_number
                     ? (int64_t)lp.timestamp.num : -1);
    helpful.push_back(lp.helpful.present && lp.helpful.is_number
                          ? (float)lp.helpful.num : NAN);
    verified.push_back(lp.verified.present && lp.verified.is_bool &&
                               lp.verified.bval ? 1.0f : 0.0f);
    split.push_back((int8_t)split_bucket(uid, iid, train_p, val_p));
    positive.push_back(r >= pos_threshold ? 1 : 0);

    if (with_text) {
      hashes.clear();
      std::string text;
      if (lp.title.present && lp.title.is_string) text += lp.title.str;
      text += " ";
      if (lp.text.present && lp.text.is_string) text += lp.text.str;
      tokenize_hashes(text, &hashes);
      tokc.push_back((int32_t)hashes.size());
      tmp = hashes;
      std::sort(tmp.begin(), tmp.end());
      tmp.erase(std::unique(tmp.begin(), tmp.end()), tmp.end());
      utokc.push_back((int32_t)tmp.size());
      if (collect_tokens)
        for (uint64_t h : tmp) {
          user_tok_pairs_hi.push_back((uint64_t)u);
          user_tok_pairs_lo.push_back(h);
        }
    } else {
      tokc.push_back(0);
      utokc.push_back(0);
    }
  }
  fclose(f);

  BBResult* res = (BBResult*)calloc(1, sizeof(BBResult));
  res->n_records = (int64_t)uidx.size();
  res->n_users = (int64_t)user_ids.size();
  res->n_items = (int64_t)item_ids.size();
  res->bad_lines = bad;
  res->uidx = arr_from(uidx);
  res->iidx = arr_from(iidx);
  res->rating = arr_from(rating);
  res->timestamp = arr_from(ts);
  res->helpful = arr_from(helpful);
  res->verified = arr_from(verified);
  res->split = arr_from(split);
  res->positive = arr_from(positive);
  res->tok_count = arr_from(tokc);
  res->uniq_tok_count = arr_from(utokc);
  res->user_id_blob = blob_from(user_ids, &res->user_id_offsets);
  res->item_id_blob = blob_from(item_ids, &res->item_id_offsets);

  res->label_total = (int64_t*)calloc(user_ids.size() ? user_ids.size() : 1,
                                      sizeof(int64_t));
  res->label_helpful = (int64_t*)calloc(user_ids.size() ? user_ids.size() : 1,
                                        sizeof(int64_t));
  for (size_t u = 0; u < user_ids.size(); u++) {
    auto itc = label_counts.find(user_ids[u]);
    if (itc != label_counts.end()) {
      res->label_total[u] = itc->second.first;
      res->label_helpful[u] = itc->second.second;
    }
  }

  if (collect_tokens) {
    // unique (user, token) pairs -> per-user unique token counts
    std::vector<size_t> order(user_tok_pairs_hi.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = i;
    std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
      if (user_tok_pairs_hi[a] != user_tok_pairs_hi[b])
        return user_tok_pairs_hi[a] < user_tok_pairs_hi[b];
      return user_tok_pairs_lo[a] < user_tok_pairs_lo[b];
    });
    res->user_unique_tokens = (int64_t*)calloc(
        user_ids.size() ? user_ids.size() : 1, sizeof(int64_t));
    uint64_t pu = ~0ull, ph = 0;
    bool first = true;
    for (size_t k : order) {
      uint64_t cu = user_tok_pairs_hi[k], ch = user_tok_pairs_lo[k];
      if (first || cu != pu || ch != ph) res->user_unique_tokens[cu]++;
      pu = cu; ph = ch; first = false;
    }
  }
  return res;
}

extern "C" void bb_free(BBResult* r) {
  if (!r) return;
  free(r->uidx); free(r->iidx); free(r->rating); free(r->timestamp);
  free(r->helpful); free(r->verified); free(r->split); free(r->positive);
  free(r->tok_count); free(r->uniq_tok_count);
  free(r->user_id_blob); free(r->user_id_offsets);
  free(r->item_id_blob); free(r->item_id_offsets);
  free(r->label_total); free(r->label_helpful);
  free(r->user_unique_tokens);
  free(r);
}

// Standalone md5 split for parity tests.
extern "C" int bb_split_bucket(const char* uid, const char* iid,
                               double train_p, double val_p) {
  return split_bucket(uid, iid, train_p, val_p);
}
