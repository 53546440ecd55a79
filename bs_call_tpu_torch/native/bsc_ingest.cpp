// bsc_ingest: native BAM ingest for bs_call_tpu.
//
// Role analogue: the reference's input path (htslib BGZF codec threads +
// input_sam.c record decode), re-built as a batch-oriented library: a
// multithreaded BGZF inflater feeds a record parser that fills
// struct-of-arrays buffers handed in from Python (ctypes). Per-record
// outputs include the packed (base | qual<<2) read bytes (input_sam.c:77-87
// encoding), the bisulfite-strand aux-tag classification
// (input_sam.c:144-220) and raw CIGAR words.

#include "bsc_common.h"

using bsc::Reader;
using bsc::RawRec;

extern "C" {

void *bsc_open(const char *path, int nthreads) {
    return bsc::open_reader(path, nthreads);
}

void bsc_close(void *h) { delete (Reader *)h; }

int bsc_n_refs(void *h) { return (int)((Reader *)h)->ref_names.size(); }
const char *bsc_ref_name(void *h, int i) {
    return ((Reader *)h)->ref_names[i].c_str();
}
int bsc_ref_len(void *h, int i) { return ((Reader *)h)->ref_lens[i]; }
const char *bsc_header_text(void *h) {
    return ((Reader *)h)->header_text.c_str();
}

// Fetch up to max_records records into SoA buffers; see reader.py.
int bsc_next_batch(void *h, int max_records,
                   int32_t *tid, int32_t *posv, int32_t *mtid, int32_t *mposv,
                   int32_t *isize, uint16_t *flag, uint8_t *mapq,
                   int32_t *strand,
                   int64_t *cigar_off, uint32_t *cigar_buf, int64_t cigar_cap,
                   int64_t *seq_off, uint8_t *seq_buf, int64_t seq_cap,
                   int64_t *name_off, char *name_buf, int64_t name_cap) {
    Reader *r = (Reader *)h;
    int count = 0;
    int64_t cig_n = 0, seq_n = 0, name_n = 0;
    cigar_off[0] = seq_off[0] = name_off[0] = 0;
    while (count < max_records) {
        size_t save = r->pos;
        RawRec rec;
        if (!bsc::next_record(*r, rec)) break;
        if (cig_n + rec.n_cigar > cigar_cap ||
            seq_n + bsc::pack_read_cap(rec.l_seq) > seq_cap ||
            name_n + rec.name_len > name_cap) {
            r->pos = save;
            break;
        }
        memcpy(name_buf + name_n, rec.name, rec.name_len);
        name_n += rec.name_len;
        memcpy(cigar_buf + cig_n, rec.cigar, (size_t)rec.n_cigar * 4);
        cig_n += rec.n_cigar;
        bsc::pack_read(rec, seq_buf + seq_n);
        seq_n += rec.l_seq;
        strand[count] = bsc::scan_bs_strand(rec.aux, rec.aux_end);
        tid[count] = rec.tid;
        posv[count] = rec.pos;
        mtid[count] = rec.mtid;
        mposv[count] = rec.mpos;
        isize[count] = rec.isize;
        flag[count] = rec.flag;
        mapq[count] = rec.mapq;
        count++;
        cigar_off[count] = cig_n;
        seq_off[count] = seq_n;
        name_off[count] = name_n;
    }
    return count;
}

}  // extern "C"
