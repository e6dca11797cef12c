// The protobuf-free core build's stand-in for
// <google/protobuf/descriptor.h>: the two accessors cpp/rpc/channel.cc:388
// reads in Channel::CallMethod (a method's name and its service's name).
// No descriptor exists in such a build, so these are never constructed.
#pragma once

#include <string>

namespace google {
namespace protobuf {

class ServiceDescriptor {
 public:
  const std::string& name() const { return name_; }

 private:
  std::string name_;
};

class MethodDescriptor {
 public:
  const std::string& name() const { return name_; }
  const ServiceDescriptor* service() const { return service_; }

 private:
  std::string name_;
  const ServiceDescriptor* service_ = nullptr;
};

}  // namespace protobuf
}  // namespace google
