// The protobuf-free core build's stand-in for <google/protobuf/service.h>.
//
// The shared C++ core (cpp/) uses protobuf's RPC interfaces only as base
// classes: cpp/rpc/controller.h:35 derives Controller from RpcController
// and overrides exactly the seven virtuals below (:38-:116), and
// cpp/rpc/channel.h:90 makes Channel an RpcChannel. Declaring those
// abstract classes here, first on the include path, lets the same sources
// build where no protobuf is installed. Typed protobuf calls (generated
// services, serialisation, JSON) are absent from such a build: see
// tbus_torch/csrc/pb_absent.cc.
#pragma once

#include <string>

namespace google {
namespace protobuf {

class Message;            // message.h
class MethodDescriptor;   // descriptor.h
class ServiceDescriptor;  // descriptor.h

class Closure {
 public:
  Closure() = default;
  virtual ~Closure() = default;
  Closure(const Closure&) = delete;
  Closure& operator=(const Closure&) = delete;
  virtual void Run() = 0;
};

class RpcController {
 public:
  RpcController() = default;
  virtual ~RpcController() = default;
  RpcController(const RpcController&) = delete;
  RpcController& operator=(const RpcController&) = delete;
  virtual void Reset() = 0;
  virtual bool Failed() const = 0;
  virtual std::string ErrorText() const = 0;
  virtual void StartCancel() = 0;
  virtual void SetFailed(const std::string& reason) = 0;
  virtual bool IsCanceled() const = 0;
  virtual void NotifyOnCancel(Closure* callback) = 0;
};

class RpcChannel {
 public:
  RpcChannel() = default;
  virtual ~RpcChannel() = default;
  RpcChannel(const RpcChannel&) = delete;
  RpcChannel& operator=(const RpcChannel&) = delete;
  virtual void CallMethod(const MethodDescriptor* method,
                          RpcController* controller, const Message* request,
                          Message* response, Closure* done) = 0;
};

// A generated service. Nothing in a protobuf-free build can make one, so
// only the type is needed (cpp/rpc/pb.h names it in AddPbService).
class Service {
 public:
  Service() = default;
  virtual ~Service() = default;
  Service(const Service&) = delete;
  Service& operator=(const Service&) = delete;
};

}  // namespace protobuf
}  // namespace google
