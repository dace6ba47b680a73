// Host index builders of the Megatron-style datasets: the port's own copy
// of the JAX package's native/index_helpers.cpp (the reference's pybind11
// helpers.cpp: build_sample_idx, build_mapping, build_blocks_mapping and
// build_blending_indices), with a plain C interface bound through ctypes
// by fengshen_tpu_torch/data/megatron_dataloader/helpers.py. Every buffer
// is a caller-allocated numpy array. The bodies are those of the copy, so
// the same inputs and seed give the same indices bitwise (build_mapping
// draws from std::mt19937_64 through std::uniform_real_distribution).
//
// Built at first use by the host C++ compiler
// (c++ -O3 -std=c++17 -shared -fPIC) into fengshen_tpu_torch/_build/.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>

extern "C" {

// GPT contiguous-token sample index (reference: helpers.cpp:101
// build_sample_idx): walks documents in doc_idx order packing tokens into
// seq_length-sized samples. sample_idx is [(num_samples+1) * 2] int32:
// (document position, token offset) per sample boundary.
void build_sample_idx(const int32_t* sizes, const int32_t* doc_idx,
                      int64_t doc_idx_len, int32_t seq_length,
                      int32_t num_epochs, int64_t tokens_per_epoch,
                      int32_t* sample_idx, int64_t num_samples) {
    (void)num_epochs;
    (void)tokens_per_epoch;
    int64_t sample = 0;
    int64_t doc_pos = 0;     // index into doc_idx
    int32_t doc_offset = 0;  // token offset within current document
    sample_idx[0] = 0;
    sample_idx[1] = 0;
    while (sample < num_samples) {
        int64_t remaining = seq_length + 1;  // +1 for the shifted label
        while (remaining > 0 && doc_pos < doc_idx_len) {
            int32_t doc_len = sizes[doc_idx[doc_pos]] - doc_offset;
            if (doc_len >= remaining) {
                // One-token overlap (reference: helpers.cpp:165): the next
                // sample re-starts at this sample's last (label) token, so
                // every boundary token is both a label and the next input.
                doc_offset += static_cast<int32_t>(remaining) - 1;
                remaining = 0;
            } else {
                remaining -= doc_len;
                ++doc_pos;
                doc_offset = 0;
            }
        }
        ++sample;
        sample_idx[2 * sample] = static_cast<int32_t>(doc_pos);
        sample_idx[2 * sample + 1] = doc_offset;
        if (doc_pos >= doc_idx_len && sample < num_samples) {
            // ran out of tokens; repeat the final boundary
            for (int64_t s = sample + 1; s <= num_samples; ++s) {
                sample_idx[2 * s] = sample_idx[2 * sample];
                sample_idx[2 * s + 1] = sample_idx[2 * sample + 1];
            }
            break;
        }
    }
}

// Weighted multi-corpus interleave (reference: helpers.cpp:34
// build_blending_indices): greedy choice of the dataset whose current
// sampled fraction most lags its weight.
void build_blending_indices(int8_t* dataset_index,
                            int64_t* dataset_sample_index,
                            const double* weights, int32_t num_datasets,
                            int64_t size, int32_t verbose) {
    int64_t* counts = new int64_t[num_datasets];
    std::memset(counts, 0, sizeof(int64_t) * num_datasets);
    for (int64_t i = 0; i < size; ++i) {
        double denom = static_cast<double>(i + 1);
        int32_t best = 0;
        double best_gap = -1e300;
        for (int32_t d = 0; d < num_datasets; ++d) {
            double gap = weights[d] * denom - static_cast<double>(counts[d]);
            if (gap > best_gap) {
                best_gap = gap;
                best = d;
            }
        }
        dataset_index[i] = static_cast<int8_t>(best);
        dataset_sample_index[i] = counts[best];
        ++counts[best];
    }
    if (verbose) {
        std::fprintf(stderr, "blending: %lld samples over %d datasets\n",
                     static_cast<long long>(size), num_datasets);
    }
    delete[] counts;
}

// Sentence-pair map for BERT-style datasets (reference: helpers.cpp:214
// build_mapping): emit (doc start sentence, doc end sentence, target length)
// triples for every window of whole sentences fitting max_seq_length; with
// probability short_seq_prob the target length is shortened. Two-pass: call
// with maps == nullptr to count, then with the allocated buffer.
int64_t build_mapping(const int64_t* docs, int64_t num_docs,
                      const int32_t* sizes, int32_t max_seq_length,
                      double short_seq_prob, int32_t seed,
                      int64_t* maps, int64_t max_maps) {
    std::mt19937_64 rng(static_cast<uint64_t>(seed));
    std::uniform_real_distribution<double> uniform(0.0, 1.0);
    int64_t count = 0;
    for (int64_t d = 0; d < num_docs; ++d) {
        const int64_t sent_begin = docs[d];
        const int64_t sent_end = docs[d + 1];
        if (sent_end - sent_begin < 2) continue;  // need a pair
        int64_t start = sent_begin;
        int32_t target = max_seq_length;
        if (uniform(rng) < short_seq_prob) {
            target = 2 + static_cast<int32_t>(
                uniform(rng) * (max_seq_length - 2));
        }
        int32_t len = 0;
        int64_t n_sent = 0;
        for (int64_t s = sent_begin; s < sent_end; ++s) {
            len += sizes[s];
            ++n_sent;
            const bool last = (s == sent_end - 1);
            if ((len >= target && n_sent >= 2) || (last && n_sent >= 2)) {
                if (maps != nullptr) {
                    if (count >= max_maps) return count;
                    maps[3 * count] = start;
                    maps[3 * count + 1] = s + 1;
                    maps[3 * count + 2] = target;
                }
                ++count;
                start = s + 1;
                len = 0;
                n_sent = 0;
                target = max_seq_length;
                if (uniform(rng) < short_seq_prob) {
                    target = 2 + static_cast<int32_t>(
                        uniform(rng) * (max_seq_length - 2));
                }
            }
        }
    }
    return count;
}

// Block map for span/ICT-style datasets (reference: helpers.cpp:513
// build_blocks_mapping): one entry per sentence window of at most
// max_seq_length tokens, no pairing requirement.
int64_t build_blocks_mapping(const int64_t* docs, int64_t num_docs,
                             const int32_t* sizes, int32_t max_seq_length,
                             int64_t* maps, int64_t max_maps) {
    int64_t count = 0;
    for (int64_t d = 0; d < num_docs; ++d) {
        int64_t start = docs[d];
        int32_t len = 0;
        for (int64_t s = docs[d]; s < docs[d + 1]; ++s) {
            if (len + sizes[s] > max_seq_length && len > 0) {
                if (maps != nullptr) {
                    if (count >= max_maps) return count;
                    maps[3 * count] = start;
                    maps[3 * count + 1] = s;
                    maps[3 * count + 2] = len;
                }
                ++count;
                start = s;
                len = 0;
            }
            len += sizes[s];
        }
        if (len > 0 && docs[d + 1] > start) {
            if (maps != nullptr) {
                if (count < max_maps) {
                    maps[3 * count] = start;
                    maps[3 * count + 1] = docs[d + 1];
                    maps[3 * count + 2] = len;
                }
            }
            ++count;
        }
    }
    return count;
}

}  // extern "C"
