// The protobuf-free core build's stand-in for <google/protobuf/message.h>:
// cpp/rpc/pb.h names Message only by reference and pointer.
#pragma once

namespace google {
namespace protobuf {

class Message {
 public:
  Message() = default;
  virtual ~Message() = default;
  Message(const Message&) = delete;
  Message& operator=(const Message&) = delete;
};

}  // namespace protobuf
}  // namespace google
