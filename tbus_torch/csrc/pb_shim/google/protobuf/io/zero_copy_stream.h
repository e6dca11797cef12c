// The protobuf-free core build's stand-in for
// <google/protobuf/io/zero_copy_stream.h>: the two stream interfaces
// cpp/rpc/pb.h:30,46 implements over IOBuf, with the virtuals it
// overrides.
#pragma once

#include <cstdint>

namespace google {
namespace protobuf {
namespace io {

class ZeroCopyInputStream {
 public:
  ZeroCopyInputStream() = default;
  virtual ~ZeroCopyInputStream() = default;
  ZeroCopyInputStream(const ZeroCopyInputStream&) = delete;
  ZeroCopyInputStream& operator=(const ZeroCopyInputStream&) = delete;
  virtual bool Next(const void** data, int* size) = 0;
  virtual void BackUp(int count) = 0;
  virtual bool Skip(int count) = 0;
  virtual int64_t ByteCount() const = 0;
};

class ZeroCopyOutputStream {
 public:
  ZeroCopyOutputStream() = default;
  virtual ~ZeroCopyOutputStream() = default;
  ZeroCopyOutputStream(const ZeroCopyOutputStream&) = delete;
  ZeroCopyOutputStream& operator=(const ZeroCopyOutputStream&) = delete;
  virtual bool Next(void** data, int* size) = 0;
  virtual void BackUp(int count) = 0;
  virtual int64_t ByteCount() const = 0;
};

}  // namespace io
}  // namespace protobuf
}  // namespace google
