// cpp/rpc/pb.h for a core built without libprotobuf: it takes the place
// of cpp/rpc/pb.cc in the port's protobuf-free build of the shared core
// (tbus_torch/csrc/core/CMakeLists.txt), where the headers under
// tbus_torch/csrc/pb_shim declare protobuf's abstract RPC classes.
//
// The byte-oriented core (servers, channels, streams, the device plane)
// never touches a typed message, so it is whole in such a build. What
// needs libprotobuf fails, saying why: serialisation, JSON transcoding,
// typed calls and generated services. The IOBuf zero-copy streams need
// nothing of protobuf's implementation and work as in pb.cc.

#include "rpc/pb.h"

#include "base/logging.h"
#include "rpc/errors.h"

namespace tbus {

namespace {
constexpr char kAbsent[] =
    "typed protobuf calls are absent: this core was built without "
    "libprotobuf (protobuf-free build, tbus_torch/csrc/pb_absent.cc)";
}  // namespace

// ---------------- zero-copy streams (as rpc/pb.cc) ----------------

IOBufAsZeroCopyInputStream::IOBufAsZeroCopyInputStream(const IOBuf& buf)
    : buf_(&buf) {}

bool IOBufAsZeroCopyInputStream::Next(const void** data, int* size) {
  while (ref_index_ < buf_->backing_block_num()) {
    IOBuf::BlockView v = buf_->backing_block(ref_index_);
    if (in_ref_offset_ < v.size) {
      *data = v.data + in_ref_offset_;
      *size = int(v.size - in_ref_offset_);
      byte_count_ += *size;
      in_ref_offset_ = v.size;
      return true;
    }
    ++ref_index_;
    in_ref_offset_ = 0;
  }
  return false;
}

void IOBufAsZeroCopyInputStream::BackUp(int count) {
  CHECK(count >= 0 && size_t(count) <= in_ref_offset_);
  in_ref_offset_ -= size_t(count);
  byte_count_ -= count;
}

bool IOBufAsZeroCopyInputStream::Skip(int count) {
  const void* data;
  int size;
  while (count > 0) {
    if (!Next(&data, &size)) return false;
    if (size > count) {
      BackUp(size - count);
      return true;
    }
    count -= size;
  }
  return true;
}

bool IOBufAsZeroCopyOutputStream::Next(void** data, int* size) {
  size_t cap = 0;
  char* p = buf_->append_block_window(&cap);
  if (p == nullptr) return false;
  *data = p;
  *size = int(cap);
  byte_count_ += int64_t(cap);
  return true;
}

void IOBufAsZeroCopyOutputStream::BackUp(int count) {
  CHECK(count >= 0);
  buf_->pop_back(size_t(count));
  byte_count_ -= count;
}

// ---------------- what needs libprotobuf ----------------

bool pb_serialize(const google::protobuf::Message&, IOBuf*) { return false; }

bool pb_parse(const IOBuf&, google::protobuf::Message*) { return false; }

bool pb_to_json(const google::protobuf::Message&, std::string*) {
  return false;
}

bool json_to_pb(const std::string&, google::protobuf::Message*,
                std::string* error) {
  if (error != nullptr) *error = kAbsent;
  return false;
}

void PbCall(ChannelBase*, const std::string&, const std::string&,
            Controller* cntl, const google::protobuf::Message&,
            google::protobuf::Message*, google::protobuf::Closure* done) {
  cntl->SetFailed(EREQUEST, kAbsent);
  if (done != nullptr) done->Run();
}

int AddPbService(Server*, google::protobuf::Service*, bool) {
  LOG(ERROR) << "AddPbService: " << kAbsent;
  return -1;
}

std::string pb_services_dump() {
  return std::string(kAbsent) + "\n";
}

}  // namespace tbus

// Marks a core built this way: tbus_torch._native.core_flavor() looks it
// up to tell the flavours apart.
extern "C" int tbus_core_without_protobuf(void) { return 1; }
