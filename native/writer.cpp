// Native asynchronous artifact writer.
//
// Analog of the reference's global tokio storage writer
// (/root/reference/src/storage/write.rs:363): a background worker pool drains
// a queue of (path, bytes) jobs; `mxx_writer_wait_all` is the completion
// barrier. Exposed through a C ABI consumed via ctypes.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libmxxwriter.so writer.cpp

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
    std::string path;
    std::vector<uint8_t> data;
};

class Writer {
  public:
    explicit Writer(unsigned workers) : pending_(0), stop_(false) {
        for (unsigned i = 0; i < workers; ++i) {
            threads_.emplace_back([this] { this->run(); });
        }
    }

    ~Writer() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : threads_) t.join();
    }

    void submit(const char* path, const uint8_t* data, uint64_t len) {
        Job job;
        job.path = path;
        job.data.assign(data, data + len);
        {
            std::unique_lock<std::mutex> lk(mu_);
            ++pending_;
            queue_.push(std::move(job));
        }
        cv_.notify_one();
    }

    void wait_all() {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [this] { return pending_ == 0; });
    }

    uint64_t errors() const { return errors_; }

  private:
    void run() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
                if (stop_ && queue_.empty()) return;
                job = std::move(queue_.front());
                queue_.pop();
            }
            // Crash-safe: write the full payload to a temp path, then rename
            // atomically — a reader (or a resumed run) can never observe a
            // partially written artifact (ADVICE r1 medium).
            const std::string tmp = job.path + ".tmp";
            FILE* f = std::fopen(tmp.c_str(), "wb");
            if (f != nullptr) {
                bool ok =
                    std::fwrite(job.data.data(), 1, job.data.size(), f) == job.data.size();
                ok = (std::fclose(f) == 0) && ok;
                if (!ok || std::rename(tmp.c_str(), job.path.c_str()) != 0) {
                    ++errors_;
                    std::remove(tmp.c_str());
                }
            } else {
                ++errors_;
            }
            {
                std::unique_lock<std::mutex> lk(mu_);
                if (--pending_ == 0) done_cv_.notify_all();
            }
        }
    }

    std::mutex mu_;
    std::condition_variable cv_;
    std::condition_variable done_cv_;
    std::queue<Job> queue_;
    std::vector<std::thread> threads_;
    uint64_t pending_;
    bool stop_;
    uint64_t errors_ = 0;
};

Writer* g_writer = nullptr;

}  // namespace

extern "C" {

void mxx_writer_init(uint32_t workers) {
    if (g_writer == nullptr) {
        g_writer = new Writer(workers == 0 ? 4 : workers);
    }
}

void mxx_writer_submit(const char* path, const uint8_t* data, uint64_t len) {
    if (g_writer == nullptr) mxx_writer_init(0);
    g_writer->submit(path, data, len);
}

void mxx_writer_wait_all() {
    if (g_writer != nullptr) g_writer->wait_all();
}

uint64_t mxx_writer_errors() {
    return g_writer == nullptr ? 0 : g_writer->errors();
}

}  // extern "C"
