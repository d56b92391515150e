// C++ client for the ray_tpu_torch cluster protocol.
//
// Analog of the reference's C++ worker/user API (cpp/include/ray/api/):
// connect to a cluster, use the KV store, and invoke cross-language tasks
// (Python functions registered via ray_tpu_torch.cross_language.register_function)
// with msgpack-encoded arguments and results.
//
// Wire protocol (ray_tpu_torch/_private/protocol.py): u32-LE length-prefixed
// msgpack maps over a unix or TCP socket. Replies carry the request's "i"
// plus "r":1. This header is self-contained: it includes a minimal msgpack
// encoder/decoder covering the message subset the protocol uses.

#pragma once

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <random>
#include <stdexcept>
#include <string>
#include <vector>

namespace ray_tpu_torch {

// ---------------------------------------------------------------- msgpack

struct Value {
  enum Type { NIL, BOOL, INT, FLOAT, STR, BIN, ARRAY, MAP } type = NIL;
  bool b = false;
  int64_t i = 0;
  double f = 0.0;
  std::string s;                 // STR and BIN payloads
  std::vector<Value> arr;
  std::map<std::string, Value> map;  // string-keyed maps only (protocol)

  bool is_nil() const { return type == NIL; }
  const Value* get(const std::string& key) const {
    auto it = map.find(key);
    return it == map.end() ? nullptr : &it->second;
  }
};

class Packer {
 public:
  std::string out;
  void pack_map_header(uint32_t n) {
    if (n < 16) {
      out.push_back(static_cast<char>(0x80 | n));
    } else {
      out.push_back(static_cast<char>(0xde));
      push_u16(n);
    }
  }
  void pack_array_header(uint32_t n) {
    if (n < 16) {
      out.push_back(static_cast<char>(0x90 | n));
    } else {
      out.push_back(static_cast<char>(0xdc));
      push_u16(n);
    }
  }
  void pack_str(const std::string& s) {
    size_t n = s.size();
    if (n < 32) {
      out.push_back(static_cast<char>(0xa0 | n));
    } else if (n < 256) {
      out.push_back(static_cast<char>(0xd9));
      out.push_back(static_cast<char>(n));
    } else if (n < (1u << 16)) {
      out.push_back(static_cast<char>(0xda));
      push_u16(static_cast<uint16_t>(n));
    } else {
      out.push_back(static_cast<char>(0xdb));
      push_u32(static_cast<uint32_t>(n));
    }
    out.append(s);
  }
  void pack_bin(const std::string& b) {
    size_t n = b.size();
    if (n < 256) {
      out.push_back(static_cast<char>(0xc4));
      out.push_back(static_cast<char>(n));
    } else if (n < (1u << 16)) {
      out.push_back(static_cast<char>(0xc5));
      push_u16(static_cast<uint16_t>(n));
    } else {
      out.push_back(static_cast<char>(0xc6));
      push_u32(static_cast<uint32_t>(n));
    }
    out.append(b);
  }
  void pack_int(int64_t v) {
    if (v >= 0 && v < 128) {
      out.push_back(static_cast<char>(v));
    } else if (v < 0 && v >= -32) {
      out.push_back(static_cast<char>(v));
    } else {
      out.push_back(static_cast<char>(0xd3));
      uint64_t u = static_cast<uint64_t>(v);
      for (int shift = 56; shift >= 0; shift -= 8)
        out.push_back(static_cast<char>((u >> shift) & 0xff));
    }
  }
  void pack_double(double v) {
    out.push_back(static_cast<char>(0xcb));
    uint64_t u;
    std::memcpy(&u, &v, 8);
    for (int shift = 56; shift >= 0; shift -= 8)
      out.push_back(static_cast<char>((u >> shift) & 0xff));
  }
  void pack_bool(bool v) { out.push_back(static_cast<char>(v ? 0xc3 : 0xc2)); }
  void pack_nil() { out.push_back(static_cast<char>(0xc0)); }
  void pack_value(const Value& v) {
    switch (v.type) {
      case Value::NIL: pack_nil(); break;
      case Value::BOOL: pack_bool(v.b); break;
      case Value::INT: pack_int(v.i); break;
      case Value::FLOAT: pack_double(v.f); break;
      case Value::STR: pack_str(v.s); break;
      case Value::BIN: pack_bin(v.s); break;
      case Value::ARRAY:
        pack_array_header(static_cast<uint32_t>(v.arr.size()));
        for (const auto& e : v.arr) pack_value(e);
        break;
      case Value::MAP:
        pack_map_header(static_cast<uint32_t>(v.map.size()));
        for (const auto& kv : v.map) {
          pack_str(kv.first);
          pack_value(kv.second);
        }
        break;
    }
  }

 private:
  void push_u16(uint16_t n) {
    out.push_back(static_cast<char>(n >> 8));
    out.push_back(static_cast<char>(n & 0xff));
  }
  void push_u32(uint32_t n) {
    for (int shift = 24; shift >= 0; shift -= 8)
      out.push_back(static_cast<char>((n >> shift) & 0xff));
  }
};

class Unpacker {
 public:
  Unpacker(const char* data, size_t len) : p_(data), end_(data + len) {}

  Value unpack() {
    uint8_t tag = next();
    Value v;
    if (tag < 0x80) {  // positive fixint
      v.type = Value::INT;
      v.i = tag;
    } else if (tag >= 0xe0) {  // negative fixint
      v.type = Value::INT;
      v.i = static_cast<int8_t>(tag);
    } else if ((tag & 0xf0) == 0x80) {  // fixmap
      read_map(v, tag & 0x0f);
    } else if ((tag & 0xf0) == 0x90) {  // fixarray
      read_array(v, tag & 0x0f);
    } else if ((tag & 0xe0) == 0xa0) {  // fixstr
      read_str(v, tag & 0x1f);
    } else {
      switch (tag) {
        case 0xc0: v.type = Value::NIL; break;
        case 0xc2: v.type = Value::BOOL; v.b = false; break;
        case 0xc3: v.type = Value::BOOL; v.b = true; break;
        case 0xc4: read_bin(v, u8()); break;
        case 0xc5: read_bin(v, u16()); break;
        case 0xc6: read_bin(v, u32()); break;
        case 0xca: {
          uint32_t u = u32(); float f;
          std::memcpy(&f, &u, 4);
          v.type = Value::FLOAT; v.f = f; break;
        }
        case 0xcb: {
          uint64_t u = u64(); double d;
          std::memcpy(&d, &u, 8);
          v.type = Value::FLOAT; v.f = d; break;
        }
        case 0xcc: v.type = Value::INT; v.i = u8(); break;
        case 0xcd: v.type = Value::INT; v.i = u16(); break;
        case 0xce: v.type = Value::INT; v.i = u32(); break;
        case 0xcf: v.type = Value::INT;
                   v.i = static_cast<int64_t>(u64()); break;
        case 0xd0: v.type = Value::INT; v.i = static_cast<int8_t>(u8());
                   break;
        case 0xd1: v.type = Value::INT; v.i = static_cast<int16_t>(u16());
                   break;
        case 0xd2: v.type = Value::INT; v.i = static_cast<int32_t>(u32());
                   break;
        case 0xd3: v.type = Value::INT; v.i = static_cast<int64_t>(u64());
                   break;
        case 0xd9: read_str(v, u8()); break;
        case 0xda: read_str(v, u16()); break;
        case 0xdb: read_str(v, u32()); break;
        case 0xdc: read_array(v, u16()); break;
        case 0xdd: read_array(v, u32()); break;
        case 0xde: read_map(v, u16()); break;
        case 0xdf: read_map(v, u32()); break;
        default:
          throw std::runtime_error("msgpack: unsupported tag");
      }
    }
    return v;
  }

 private:
  const char* p_;
  const char* end_;
  uint8_t next() {
    if (p_ >= end_) throw std::runtime_error("msgpack: truncated");
    return static_cast<uint8_t>(*p_++);
  }
  uint8_t u8() { return next(); }
  uint16_t u16() {
    uint16_t hi = u8();  // sequenced: operand order in an expression
    uint16_t lo = u8();  // like (u8()<<8)|u8() is unspecified in C++
    return static_cast<uint16_t>((hi << 8) | lo);
  }
  uint32_t u32() {
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k) v = (v << 8) | u8();
    return v;
  }
  uint64_t u64() {
    uint64_t v = 0;
    for (int k = 0; k < 8; ++k) v = (v << 8) | u8();
    return v;
  }
  void take(Value& v, size_t n, Value::Type t) {
    if (p_ + n > end_) throw std::runtime_error("msgpack: truncated");
    v.type = t;
    v.s.assign(p_, n);
    p_ += n;
  }
  void read_str(Value& v, size_t n) { take(v, n, Value::STR); }
  void read_bin(Value& v, size_t n) { take(v, n, Value::BIN); }
  void read_array(Value& v, size_t n) {
    v.type = Value::ARRAY;
    v.arr.reserve(n);
    for (size_t k = 0; k < n; ++k) v.arr.push_back(unpack());
  }
  void read_map(Value& v, size_t n) {
    v.type = Value::MAP;
    for (size_t k = 0; k < n; ++k) {
      Value key = unpack();
      v.map.emplace(key.s, unpack());
    }
  }
};

// ----------------------------------------------------------------- client

namespace detail {

// Framed msgpack socket shared by the GCS connection and direct actor
// channels (wire format: uint32-LE length + msgpack payload — see
// ray_tpu_torch/_private/protocol.py).
class Socket {
 public:
  Socket() = default;
  ~Socket() { close(); }
  Socket(const Socket&) = delete;
  Socket& operator=(const Socket&) = delete;

  void connect_to(const std::string& address) {
    if (address.rfind("unix:", 0) == 0) {
      fd_ = ::socket(AF_UNIX, SOCK_STREAM, 0);
      sockaddr_un addr{};
      addr.sun_family = AF_UNIX;
      std::string path = address.substr(5);
      std::strncpy(addr.sun_path, path.c_str(), sizeof(addr.sun_path) - 1);
      if (::connect(fd_, reinterpret_cast<sockaddr*>(&addr),
                    sizeof(addr)) != 0)
        throw std::runtime_error("connect failed: " + address);
      return;
    }
    auto colon = address.rfind(':');
    if (colon == std::string::npos)
      throw std::runtime_error("bad address: " + address);
    std::string host = address.substr(0, colon);
    std::string port = address.substr(colon + 1);
    addrinfo hints{};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (::getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0)
      throw std::runtime_error("resolve failed: " + address);
    fd_ = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    int rc = ::connect(fd_, res->ai_addr, res->ai_addrlen);
    ::freeaddrinfo(res);
    if (rc != 0) throw std::runtime_error("connect failed: " + address);
  }

  void close() {
    if (fd_ >= 0) { ::close(fd_); fd_ = -1; }
  }

  bool connected() const { return fd_ >= 0; }

  void send_frame(const std::string& payload) {
    uint32_t len = static_cast<uint32_t>(payload.size());
    char hdr[4];
    hdr[0] = static_cast<char>(len & 0xff);
    hdr[1] = static_cast<char>((len >> 8) & 0xff);
    hdr[2] = static_cast<char>((len >> 16) & 0xff);
    hdr[3] = static_cast<char>((len >> 24) & 0xff);
    write_all(hdr, 4);
    write_all(payload.data(), payload.size());
  }

  Value read_frame(double timeout_s) {
    set_timeout(timeout_s);
    char hdr[4];
    read_all(hdr, 4);
    uint32_t len = static_cast<uint8_t>(hdr[0]) |
                   (static_cast<uint8_t>(hdr[1]) << 8) |
                   (static_cast<uint8_t>(hdr[2]) << 16) |
                   (static_cast<uint8_t>(hdr[3]) << 24);
    std::string payload(len, '\0');
    read_all(payload.data(), len);
    Unpacker u(payload.data(), payload.size());
    return u.unpack();
  }

  Value request(const std::string& payload, int64_t want_id,
                double timeout_s = 30.0) {
    send_frame(payload);
    for (;;) {
      Value msg = read_frame(timeout_s);
      const Value* rid = msg.get("i");
      const Value* is_reply = msg.get("r");
      if (rid && is_reply && rid->i == want_id) return msg;
    }
  }

 private:
  int fd_ = -1;

  void set_timeout(double seconds) {
    timeval tv{};
    tv.tv_sec = static_cast<long>(seconds);
    tv.tv_usec = static_cast<long>((seconds - tv.tv_sec) * 1e6);
    ::setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  }

  void write_all(const char* data, size_t n) {
    while (n > 0) {
      ssize_t w = ::write(fd_, data, n);
      if (w <= 0) throw std::runtime_error("socket write failed");
      data += w;
      n -= static_cast<size_t>(w);
    }
  }

  void read_all(char* data, size_t n) {
    while (n > 0) {
      ssize_t r = ::read(fd_, data, n);
      if (r <= 0) throw std::runtime_error("socket read failed/timeout");
      data += r;
      n -= static_cast<size_t>(r);
    }
  }
};

inline std::string random_bytes(size_t n) {
  static std::mt19937_64 rng(std::random_device{}());
  std::string out(n, '\0');
  for (size_t k = 0; k < n; ++k)
    out[k] = static_cast<char>(rng() & 0xff);
  return out;
}

inline Value unpack_xlang_result(const Value& reply) {
  const Value* results = reply.get("results");
  if (!results || results->arr.empty())
    throw std::runtime_error("reply without results");
  const Value* data = results->arr[0].get("data");
  if (!data) throw std::runtime_error("non-inline xlang result");
  Unpacker u(data->s.data(), data->s.size());
  Value out = u.unpack();
  const Value* err = out.get("__xlang_error__");
  if (out.type == Value::MAP && err)
    throw std::runtime_error("remote error: " + err->s);
  return out;
}

inline std::string pack_xlang_args(const std::vector<Value>& args) {
  Packer inner;
  inner.pack_array_header(static_cast<uint32_t>(args.size()));
  for (const auto& a : args) inner.pack_value(a);
  return inner.out;
}

}  // namespace detail

class Client;

// A handle to a Python actor created from C++ (reference: the C++ user
// API actor surface, cpp/include/ray/api/actor_handle.h). Method calls
// ride the actor\'s DIRECT channel — the same socket Python callers use —
// with msgpack (xlang) argument/result encoding.
class Actor {
 public:
  // Call a method with msgpack args; blocks for the msgpack result.
  Value call(const std::string& method, const std::vector<Value>& args,
             double timeout_s = 60.0) {
    Packer p;
    p.pack_map_header(8);
    p.pack_str("t"); p.pack_str("actor_call");
    p.pack_str("aid"); p.pack_bin(aid_);
    p.pack_str("tid"); p.pack_bin(detail::random_bytes(16));
    p.pack_str("m"); p.pack_str(method);
    p.pack_str("nret"); p.pack_int(1);
    p.pack_str("opts");
    p.pack_map_header(1);
    p.pack_str("xlang"); p.pack_bool(true);
    p.pack_str("args"); p.pack_bin(detail::pack_xlang_args(args));
    p.pack_str("i"); p.pack_int(++id_counter_);
    Value reply = sock_.request(p.out, id_counter_, timeout_s);
    return detail::unpack_xlang_result(reply);
  }

  const std::string& id() const { return aid_; }

 private:
  friend class Client;
  Actor(const std::string& aid, const std::string& addr) : aid_(aid) {
    sock_.connect_to(addr);
  }

  std::string aid_;
  detail::Socket sock_;
  int64_t id_counter_ = 1000;
};

class Client {
 public:
  // address: "unix:/path/to/gcs.sock" or "host:port"
  explicit Client(const std::string& address) {
    sock_.connect_to(address);
    // hello handshake (role=driver; random worker id).
    Packer p;
    p.pack_map_header(5);
    p.pack_str("t"); p.pack_str("hello");
    p.pack_str("role"); p.pack_str("driver");
    p.pack_str("worker_id"); p.pack_bin(detail::random_bytes(16));
    p.pack_str("pid"); p.pack_int(static_cast<int64_t>(::getpid()));
    p.pack_str("i"); p.pack_int(next_id());
    Value reply = sock_.request(p.out, last_id_);
    const Value* session = reply.get("session");
    if (!session) throw std::runtime_error("hello failed");
    session_ = session->s;
  }

  const std::string& session() const { return session_; }

  void kv_put(const std::string& key, const std::string& value,
              const std::string& ns = "") {
    Packer p;
    p.pack_map_header(5);
    p.pack_str("t"); p.pack_str("kv_put");
    p.pack_str("k"); p.pack_str(key);
    p.pack_str("v"); p.pack_bin(value);
    p.pack_str("ns"); p.pack_str(ns);
    p.pack_str("i"); p.pack_int(next_id());
    sock_.request(p.out, last_id_);
  }

  bool kv_get(const std::string& key, std::string* value,
              const std::string& ns = "") {
    Packer p;
    p.pack_map_header(4);
    p.pack_str("t"); p.pack_str("kv_get");
    p.pack_str("k"); p.pack_str(key);
    p.pack_str("ns"); p.pack_str(ns);
    p.pack_str("i"); p.pack_int(next_id());
    Value reply = sock_.request(p.out, last_id_);
    const Value* ok = reply.get("ok");
    if (!ok || !ok->b) return false;
    const Value* v = reply.get("v");
    if (!v || v->is_nil()) return false;
    *value = v->s;
    return true;
  }

  // Invoke a Python function registered with
  // ray_tpu_torch.cross_language.register_function(name, fn).
  // `args` is a packed msgpack ARRAY of the positional arguments.
  // Returns the msgpack-encoded result payload.
  Value call(const std::string& name, const std::vector<Value>& args,
             double timeout_s = 60.0) {
    std::string tid = detail::random_bytes(16);
    Packer p;
    p.pack_map_header(5);
    p.pack_str("t"); p.pack_str("submit");
    p.pack_str("tid"); p.pack_bin(tid);
    p.pack_str("fid"); p.pack_str(name);
    p.pack_str("opts");
    p.pack_map_header(4);
    p.pack_str("res");
    p.pack_map_header(1);
    p.pack_str("CPU"); p.pack_double(1.0);
    p.pack_str("name"); p.pack_str(name);
    p.pack_str("xlang"); p.pack_bool(true);
    p.pack_str("retries"); p.pack_int(0);
    p.pack_str("args"); p.pack_bin(detail::pack_xlang_args(args));
    sock_.send_frame(p.out);
    // Wait for the task_done push for our tid.
    for (;;) {
      Value msg = sock_.read_frame(timeout_s);
      const Value* t = msg.get("t");
      if (t && t->s == "task_done") {
        const Value* got = msg.get("tid");
        if (got && got->s == tid) return detail::unpack_xlang_result(msg);
      }
      // Unrelated pushes (metrics acks etc.) are skipped.
    }
  }

  // Create a Python actor from a class registered with
  // ray_tpu_torch.cross_language.register_function(name, cls) and return a
  // direct-channel handle (reference: cpp/include/ray/api/ actor
  // creation + handle surface).
  Actor create_actor(const std::string& registered_class,
                     const std::vector<Value>& init_args,
                     double timeout_s = 60.0) {
    std::string aid = detail::random_bytes(16);
    Packer p;
    p.pack_map_header(6);
    p.pack_str("t"); p.pack_str("actor_create");
    p.pack_str("aid"); p.pack_bin(aid);
    p.pack_str("fid"); p.pack_str(registered_class);
    p.pack_str("opts");
    p.pack_map_header(2);
    p.pack_str("xlang"); p.pack_bool(true);
    p.pack_str("res");
    p.pack_map_header(1);
    p.pack_str("CPU"); p.pack_double(0.0);
    p.pack_str("args"); p.pack_bin(detail::pack_xlang_args(init_args));
    p.pack_str("i"); p.pack_int(next_id());
    Value reply = sock_.request(p.out, last_id_, timeout_s);
    const Value* ok = reply.get("ok");
    if (!ok || !ok->b) throw std::runtime_error("actor_create failed");
    // Resolve the direct-channel address (GCS waits while pending).
    Packer g;
    g.pack_map_header(3);
    g.pack_str("t"); g.pack_str("actor_get");
    g.pack_str("aid"); g.pack_bin(aid);
    g.pack_str("i"); g.pack_int(next_id());
    Value got = sock_.request(g.out, last_id_, timeout_s);
    const Value* gok = got.get("ok");
    const Value* addr = got.get("addr");
    if (!gok || !gok->b || !addr)
      throw std::runtime_error("actor did not become ready");
    return Actor(aid, addr->s);
  }

  void kill_actor(const Actor& actor) {
    Packer p;
    p.pack_map_header(3);
    p.pack_str("t"); p.pack_str("actor_kill");
    p.pack_str("aid"); p.pack_bin(actor.id());
    p.pack_str("no_restart"); p.pack_bool(true);
    sock_.send_frame(p.out);
  }

  // ------------------------------------------------------------- objects
  // Standalone object put/get (reference: cpp/include/ray/api/object_ref.h
  // Put/Get). Values are stored in the LANGUAGE-NEUTRAL object framing:
  //   u32 header_len | msgpack {"x": <msgpack payload>, "o": [], "l": []}
  // — the same container Python's serializer uses, with the pickle field
  // ("p") replaced by a msgpack field ("x") both sides can read
  // (Python: serialization.deserialize; Python puts for C++ readers via
  // ray_tpu_torch.cross_language.put_xlang).

  // Store a value; returns the 20-byte object id (TaskID(16)+index(4)).
  std::string put(const Value& v) {
    Packer payload;
    payload.pack_value(v);
    Packer header;
    header.pack_map_header(3);
    header.pack_str("x"); header.pack_bin(payload.out);
    header.pack_str("o"); header.pack_array_header(0);
    header.pack_str("l"); header.pack_array_header(0);
    std::string blob(4, '\0');
    uint32_t hlen = static_cast<uint32_t>(header.out.size());
    blob[0] = static_cast<char>(hlen & 0xff);
    blob[1] = static_cast<char>((hlen >> 8) & 0xff);
    blob[2] = static_cast<char>((hlen >> 16) & 0xff);
    blob[3] = static_cast<char>((hlen >> 24) & 0xff);
    blob += header.out;

    std::string oid = detail::random_bytes(16) + std::string(4, '\0');
    Packer p;
    p.pack_map_header(5);
    p.pack_str("t"); p.pack_str("obj_put");
    p.pack_str("oid"); p.pack_bin(oid);
    p.pack_str("nbytes"); p.pack_int(static_cast<int64_t>(blob.size()));
    p.pack_str("data"); p.pack_bin(blob);
    p.pack_str("i"); p.pack_int(next_id());
    Value reply = sock_.request(p.out, last_id_);
    const Value* ok = reply.get("ok");
    if (!ok || !ok->b) throw std::runtime_error("obj_put failed");
    return oid;
  }

  // Fetch an object by id. Reads the xlang framing; objects written by
  // Python's cloudpickle path (no "x" field) raise — use
  // cross_language.put_xlang on the Python side for C++-readable values.
  Value get(const std::string& oid, double timeout_s = 60.0) {
    Packer p;
    p.pack_map_header(3);
    p.pack_str("t"); p.pack_str("obj_wait");
    p.pack_str("oid"); p.pack_bin(oid);
    p.pack_str("i"); p.pack_int(next_id());
    Value reply = sock_.request(p.out, last_id_, timeout_s);
    const Value* data = reply.get("data");
    std::string blob;
    if (data && !data->is_nil()) {
      blob = data->s;
    } else {
      // Shared-memory object: relay the raw bytes through the GCS
      // (obj_pull — the Ray-Client remote-driver path).
      Packer q;
      q.pack_map_header(3);
      q.pack_str("t"); q.pack_str("obj_pull");
      q.pack_str("oid"); q.pack_bin(oid);
      q.pack_str("i"); q.pack_int(next_id());
      Value pulled = sock_.request(q.out, last_id_, timeout_s);
      const Value* ok = pulled.get("ok");
      const Value* pdata = pulled.get("data");
      if (!ok || !ok->b || !pdata)
        throw std::runtime_error("obj_pull failed");
      blob = pdata->s;
    }
    return decode_object_blob(blob);
  }

  static Value decode_object_blob(const std::string& blob) {
    if (blob.size() < 4) throw std::runtime_error("short object blob");
    uint32_t hlen = static_cast<uint8_t>(blob[0]) |
                    (static_cast<uint8_t>(blob[1]) << 8) |
                    (static_cast<uint8_t>(blob[2]) << 16) |
                    (static_cast<uint8_t>(blob[3]) << 24);
    // Subtract, don't add: `4 + hlen` wraps for hlen >= 2^32-4 and a
    // corrupt header would pass the guard into an OOB read.
    if (static_cast<size_t>(hlen) > blob.size() - 4)
      throw std::runtime_error("corrupt object blob");
    Unpacker u(blob.data() + 4, hlen);
    Value header = u.unpack();
    const Value* x = header.get("x");
    if (!x)
      throw std::runtime_error(
          "object is python-pickled; store it with "
          "ray_tpu_torch.cross_language.put_xlang for C++ readers");
    Unpacker pu(x->s.data(), x->s.size());
    return pu.unpack();
  }

  static Value make_int(int64_t v) {
    Value x; x.type = Value::INT; x.i = v; return x;
  }
  static Value make_str(const std::string& s) {
    Value x; x.type = Value::STR; x.s = s; return x;
  }
  static Value make_double(double d) {
    Value x; x.type = Value::FLOAT; x.f = d; return x;
  }

 private:
  detail::Socket sock_;
  int64_t last_id_ = 0;
  int64_t id_counter_ = 0;
  std::string session_;

  int64_t next_id() {
    last_id_ = ++id_counter_;
    return last_id_;
  }
};

// --------------------------------------------------------------- executor
// C++ task EXECUTION (reference: the C++ worker runtime,
// cpp/src/ray/runtime/task/task_executor.cc): register C++ functions,
// serve a direct channel, and answer Python drivers' xlang calls —
// Python's ray_tpu_torch.cross_language.cpp_function(name) resolves this
// worker's address from the KV store and calls straight into it.
class Worker {
 public:
  using Fn = Value (*)(const std::vector<Value>&);

  Worker(const std::string& gcs_address, const std::string& name)
      : client_(gcs_address), name_(name) {}

  void register_function(const std::string& fn_name, Fn fn) {
    fns_[fn_name] = fn;
  }

  // Bind the direct-channel socket and advertise it in the KV store
  // (namespace "cppw"), then serve calls until the process is killed or
  // `max_calls` calls were handled (handy for tests; -1 = forever).
  // select()-multiplexed: many Python callers may hold connections open
  // concurrently (each CppFunction proxy keeps its own).
  void serve(const std::string& socket_path, int max_calls = -1) {
    listen_fd_ = ::socket(AF_UNIX, SOCK_STREAM, 0);
    sockaddr_un addr{};
    addr.sun_family = AF_UNIX;
    ::unlink(socket_path.c_str());
    std::strncpy(addr.sun_path, socket_path.c_str(),
                 sizeof(addr.sun_path) - 1);
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0 ||
        ::listen(listen_fd_, 16) != 0)
      throw std::runtime_error("bind/listen failed: " + socket_path);
    client_.kv_put(name_, "unix:" + socket_path, "cppw");

    std::vector<int> clients;
    int handled = 0;
    while (max_calls < 0 || handled < max_calls) {
      fd_set rfds;
      FD_ZERO(&rfds);
      FD_SET(listen_fd_, &rfds);
      int maxfd = listen_fd_;
      for (int fd : clients) {
        FD_SET(fd, &rfds);
        if (fd > maxfd) maxfd = fd;
      }
      if (::select(maxfd + 1, &rfds, nullptr, nullptr, nullptr) <= 0)
        break;
      if (FD_ISSET(listen_fd_, &rfds)) {
        int cfd = ::accept(listen_fd_, nullptr, nullptr);
        if (cfd >= 0) clients.push_back(cfd);
      }
      for (size_t k = 0; k < clients.size();) {
        int fd = clients[k];
        if (!FD_ISSET(fd, &rfds)) {
          ++k;
          continue;
        }
        try {
          Value msg = read_frame_fd(fd);
          handled += handle_call(fd, msg);
          ++k;
        } catch (const std::exception&) {
          ::close(fd);
          clients.erase(clients.begin() + static_cast<long>(k));
        }
        if (max_calls >= 0 && handled >= max_calls) break;
      }
    }
    for (int fd : clients) ::close(fd);
    ::close(listen_fd_);
  }

 private:
  Client client_;
  std::string name_;
  std::map<std::string, Fn> fns_;
  int listen_fd_ = -1;

  static Value read_frame_fd(int fd) {
    char hdr[4];
    read_all_fd(fd, hdr, 4);
    uint32_t len = static_cast<uint8_t>(hdr[0]) |
                   (static_cast<uint8_t>(hdr[1]) << 8) |
                   (static_cast<uint8_t>(hdr[2]) << 16) |
                   (static_cast<uint8_t>(hdr[3]) << 24);
    std::string payload(len, '\0');
    read_all_fd(fd, payload.data(), len);
    Unpacker u(payload.data(), payload.size());
    return u.unpack();
  }

  static void read_all_fd(int fd, char* data, size_t n) {
    while (n > 0) {
      ssize_t r = ::read(fd, data, n);
      if (r <= 0) throw std::runtime_error("peer closed");
      data += r;
      n -= static_cast<size_t>(r);
    }
  }

  static void write_frame_fd(int fd, const std::string& payload) {
    uint32_t len = static_cast<uint32_t>(payload.size());
    char hdr[4];
    hdr[0] = static_cast<char>(len & 0xff);
    hdr[1] = static_cast<char>((len >> 8) & 0xff);
    hdr[2] = static_cast<char>((len >> 16) & 0xff);
    hdr[3] = static_cast<char>((len >> 24) & 0xff);
    std::string out(hdr, 4);
    out += payload;
    const char* p = out.data();
    size_t left = out.size();
    while (left > 0) {
      ssize_t w = ::write(fd, p, left);
      if (w <= 0) throw std::runtime_error("peer write failed");
      p += w;
      left -= static_cast<size_t>(w);
    }
  }

  int handle_call(int fd, const Value& msg) {
    const Value* t = msg.get("t");
    if (t && t->s == "ping") {
      reply_map(fd, msg, {{"ok", true_val()}});
      return 0;
    }
    if (!t || t->s != "actor_call") return 0;
    const Value* m = msg.get("m");
    const Value* args = msg.get("args");
    Value result;
    bool failed = false;
    std::string err;
    auto it = m ? fns_.find(m->s) : fns_.end();
    if (it == fns_.end()) {
      failed = true;
      err = "no such C++ function: " + (m ? m->s : std::string("?"));
    } else {
      try {
        std::vector<Value> argv;
        if (args && !args->s.empty()) {
          Unpacker u(args->s.data(), args->s.size());
          Value arr = u.unpack();
          argv = arr.arr;
        }
        result = it->second(argv);
      } catch (const std::exception& e) {
        failed = true;
        err = e.what();
      }
    }
    Packer inner;
    if (failed) {
      inner.pack_map_header(1);
      inner.pack_str("__xlang_error__");
      inner.pack_str(err);
    } else {
      inner.pack_value(result);
    }
    // Reply in the task_done/results shape callers already parse.
    Packer p;
    p.pack_map_header(3);
    p.pack_str("i");
    const Value* rid = msg.get("i");
    p.pack_int(rid ? rid->i : 0);
    p.pack_str("r"); p.pack_int(1);
    p.pack_str("results");
    p.pack_array_header(1);
    p.pack_map_header(3);
    p.pack_str("oid");
    const Value* tid = msg.get("tid");
    p.pack_bin((tid ? tid->s : detail::random_bytes(16)) +
               std::string(4, '\0'));
    p.pack_str("nbytes"); p.pack_int(static_cast<int64_t>(inner.out.size()));
    p.pack_str("data"); p.pack_bin(inner.out);
    write_frame_fd(fd, p.out);
    return 1;
  }

  static Value true_val() {
    Value v; v.type = Value::BOOL; v.b = true; return v;
  }

  void reply_map(int fd, const Value& req,
                 std::map<std::string, Value> fields) {
    Packer p;
    p.pack_map_header(static_cast<uint32_t>(fields.size() + 2));
    p.pack_str("i");
    const Value* rid = req.get("i");
    p.pack_int(rid ? rid->i : 0);
    p.pack_str("r"); p.pack_int(1);
    for (const auto& kv : fields) {
      p.pack_str(kv.first);
      p.pack_value(kv.second);
    }
    write_frame_fd(fd, p.out);
  }
};

}  // namespace ray_tpu_torch
