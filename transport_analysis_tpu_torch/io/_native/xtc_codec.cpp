// GROMACS XTC compressed-coordinate codec (xdr3dfcoord algorithm).
//
// Implements the public XTC bitstream: quantized int coordinates packed
// MSB-first, either as one multiprecision triple of `bitsize` bits or
// per-component, with optional run-length delta blocks controlled by
// the magicints small-number ladder. Both directions cover the full
// format: runs of up to 8 delta triples, the adaptive ladder
// (is_smaller), change-only 5-bit run fields, and the water-pair
// seed swap.
//
// Build (io/_native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC -o libxtc_codec.so xtc_codec.cpp -lpthread

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

const int MAGICINTS[] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290,
    1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003,
    16384, 20642, 26007, 32768, 41285, 52015, 65536, 82570, 104031,
    131072, 165140, 208063, 262144, 330280, 416127, 524287, 660561,
    832255, 1048576, 1321122, 1664510, 2097152, 2642245, 3329021,
    4194304, 5284491, 6658042, 8388607, 10568983, 13316085, 16777216};
const int FIRSTIDX = 9;
const int LASTIDX = sizeof(MAGICINTS) / sizeof(*MAGICINTS) - 1;

// ---- bitstreams (MSB-first packing) -----------------------------------

struct BitWriter {
    std::vector<uint8_t> out;
    uint64_t acc = 0;
    int nacc = 0;

    void put(uint32_t value, int nbits) {
        if (nbits == 0) return;
        acc = (acc << nbits) | (value & ((nbits >= 32)
                                             ? 0xffffffffu
                                             : ((1u << nbits) - 1u)));
        nacc += nbits;
        while (nacc >= 8) {
            out.push_back((uint8_t)(acc >> (nacc - 8)));
            nacc -= 8;
        }
    }
    void flush() {
        if (nacc > 0) {
            out.push_back((uint8_t)((acc << (8 - nacc)) & 0xff));
            nacc = 0;
        }
        acc = 0;
    }
};

struct BitReader {
    const uint8_t* data;
    size_t len;
    size_t byte = 0;
    uint64_t acc = 0;
    int nacc = 0;

    uint32_t get(int nbits) {
        if (nbits == 0) return 0;
        while (nacc < nbits) {
            uint8_t b = byte < len ? data[byte] : 0;
            byte++;
            acc = (acc << 8) | b;
            nacc += 8;
        }
        uint32_t v = (uint32_t)((acc >> (nacc - nbits)) &
                                ((nbits >= 32) ? 0xffffffffu
                                               : ((1u << nbits) - 1u)));
        nacc -= nbits;
        return v;
    }
};

// ---- int sizing --------------------------------------------------------

int sizeofint(uint32_t size) {
    uint32_t num = 1;
    int bits = 0;
    while (size >= num && bits < 32) {
        bits++;
        num <<= 1;
    }
    return bits;
}

int sizeofints(int n, const uint32_t sizes[]) {
    uint32_t bytes[32];
    int num_of_bytes = 1;
    bytes[0] = 1;
    int num_of_bits = 0;
    for (int i = 0; i < n; i++) {
        uint32_t tmp = 0;
        int bytecnt;
        for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
            tmp = bytes[bytecnt] * sizes[i] + tmp;
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        num_of_bytes = bytecnt;
    }
    uint32_t num = 1;
    num_of_bytes--;
    while (bytes[num_of_bytes] >= num) {
        num_of_bits++;
        num *= 2;
    }
    return num_of_bits + num_of_bytes * 8;
}

// multiprecision pack: X = ((v0*s1)+v1)*s2+v2, little-endian bytes into
// the MSB-first stream
void sendints(BitWriter& w, int n, int num_of_bits,
              const uint32_t sizes[], const uint32_t nums[]) {
    uint32_t bytes[32];
    int num_of_bytes = 0;
    uint32_t tmp = nums[0];
    do {
        bytes[num_of_bytes++] = tmp & 0xff;
        tmp >>= 8;
    } while (tmp != 0);
    for (int i = 1; i < n; i++) {
        tmp = nums[i];
        int bytecnt;
        for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
            tmp = bytes[bytecnt] * sizes[i] + tmp;
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        num_of_bytes = bytecnt;
    }
    if (num_of_bits >= num_of_bytes * 8) {
        for (int i = 0; i < num_of_bytes; i++) w.put(bytes[i], 8);
        w.put(0, num_of_bits - num_of_bytes * 8);
    } else {
        int i;
        for (i = 0; i < num_of_bytes - 1; i++) w.put(bytes[i], 8);
        w.put(bytes[i], num_of_bits - (num_of_bytes - 1) * 8);
    }
}

void receiveints(BitReader& r, int n, int num_of_bits,
                 const uint32_t sizes[], int32_t nums[]) {
    uint32_t bytes[32];
    bytes[0] = bytes[1] = bytes[2] = bytes[3] = 0;
    int num_of_bytes = 0;
    while (num_of_bits > 8) {
        bytes[num_of_bytes++] = r.get(8);
        num_of_bits -= 8;
    }
    if (num_of_bits > 0) bytes[num_of_bytes++] = r.get(num_of_bits);
    for (int i = n - 1; i > 0; i--) {
        uint32_t num = 0;
        for (int j = num_of_bytes - 1; j >= 0; j--) {
            num = (num << 8) | bytes[j];
            uint32_t p = num / sizes[i];
            bytes[j] = p;
            num = num - p * sizes[i];
        }
        nums[i] = (int32_t)num;
    }
    nums[0] = (int32_t)(bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) |
                        (bytes[3] << 24));
}

}  // namespace

extern "C" {

// Decode one compressed coordinate block.
//   natoms      atom count (>9; small frames are stored uncompressed)
//   precision   quantization (counts per nm)
//   minint/maxint  per-axis quantized bounds (from the frame header)
//   smallidx    initial small-number ladder index
//   data/len    compressed payload bytes
//   out         (natoms*3) floats, in the file's native units (nm)
// Returns 0 on success.
int xtc_decode(int64_t natoms, float precision, const int32_t minint[3],
               const int32_t maxint[3], int32_t smallidx,
               const uint8_t* data, int64_t len, float* out) {
    uint32_t sizeint[3], sizesmall[3];
    int bitsizeint[3] = {0, 0, 0};
    int bitsize;
    for (int i = 0; i < 3; i++)
        sizeint[i] = (uint32_t)(maxint[i] - minint[i]) + 1;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        bitsizeint[0] = sizeofint(sizeint[0]);
        bitsizeint[1] = sizeofint(sizeint[1]);
        bitsizeint[2] = sizeofint(sizeint[2]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }
    if (smallidx < FIRSTIDX) smallidx = FIRSTIDX;
    int tmpidx = smallidx - 1;
    tmpidx = (FIRSTIDX > tmpidx) ? FIRSTIDX : tmpidx;
    int32_t smaller = MAGICINTS[tmpidx] / 2;
    int32_t smallnum = MAGICINTS[smallidx] / 2;
    sizesmall[0] = sizesmall[1] = sizesmall[2] =
        (uint32_t)MAGICINTS[smallidx];

    float inv_precision = 1.0f / precision;
    BitReader r{data, (size_t)len};
    int32_t prevcoord[3] = {0, 0, 0};
    int64_t i = 0;
    float* lfp = out;
    int run = 0;

    while (i < natoms) {
        int32_t thiscoord[3];
        if (bitsize == 0) {
            thiscoord[0] = (int32_t)r.get(bitsizeint[0]);
            thiscoord[1] = (int32_t)r.get(bitsizeint[1]);
            thiscoord[2] = (int32_t)r.get(bitsizeint[2]);
        } else {
            receiveints(r, 3, bitsize, sizeint, thiscoord);
        }
        i++;
        thiscoord[0] += minint[0];
        thiscoord[1] += minint[1];
        thiscoord[2] += minint[2];
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];

        int flag = (int)r.get(1);
        int is_smaller = 0;
        if (flag == 1) {
            run = (int)r.get(5);
            is_smaller = run % 3;
            run -= is_smaller;
            is_smaller--;
        }
        // flag == 0 means "run length unchanged": the previous run
        // value PERSISTS (xdrfile semantics — the encoder only emits
        // the 5-bit field when the length or the ladder changes).
        // Bound-check against the output buffer: a corrupt/truncated
        // file must never write past natoms*3 floats (untrusted input).
        if (run < 0 || i + run / 3 > natoms) return 3;
        if (run > 0) {
            for (int k = 0; k < run; k += 3) {
                receiveints(r, 3, smallidx, sizesmall, thiscoord);
                i++;
                thiscoord[0] += prevcoord[0] - smallnum;
                thiscoord[1] += prevcoord[1] - smallnum;
                thiscoord[2] += prevcoord[2] - smallnum;
                if (k == 0) {
                    // swap the first run atom with the seed atom
                    // (water-molecule optimization in the format)
                    int32_t t;
                    t = thiscoord[0]; thiscoord[0] = prevcoord[0];
                    prevcoord[0] = t;
                    t = thiscoord[1]; thiscoord[1] = prevcoord[1];
                    prevcoord[1] = t;
                    t = thiscoord[2]; thiscoord[2] = prevcoord[2];
                    prevcoord[2] = t;
                    *lfp++ = prevcoord[0] * inv_precision;
                    *lfp++ = prevcoord[1] * inv_precision;
                    *lfp++ = prevcoord[2] * inv_precision;
                } else {
                    prevcoord[0] = thiscoord[0];
                    prevcoord[1] = thiscoord[1];
                    prevcoord[2] = thiscoord[2];
                }
                *lfp++ = thiscoord[0] * inv_precision;
                *lfp++ = thiscoord[1] * inv_precision;
                *lfp++ = thiscoord[2] * inv_precision;
            }
        } else {
            *lfp++ = thiscoord[0] * inv_precision;
            *lfp++ = thiscoord[1] * inv_precision;
            *lfp++ = thiscoord[2] * inv_precision;
        }
        smallidx += is_smaller;
        if (is_smaller < 0) {
            smallnum = smaller;
            if (smallidx > FIRSTIDX)
                smaller = MAGICINTS[smallidx - 1] / 2;
            else
                smaller = 0;
        } else if (is_smaller > 0) {
            smaller = smallnum;
            smallnum = MAGICINTS[smallidx] / 2;
        }
        sizesmall[0] = sizesmall[1] = sizesmall[2] =
            (uint32_t)MAGICINTS[smallidx];
        if (sizesmall[0] == 0) return 1;  // corrupted ladder
    }
    return 0;
}

// Encode coordinates (nm floats) into the XTC compressed block with
// the full run-length small-number scheme (the xdr3dfcoord encoder:
// adaptive magicints ladder, delta runs up to 8 triples, the
// water-pair seed swap, and change-only 5-bit run fields).
//   coords (natoms*3), precision counts/nm
//   out buffer of capacity cap; header ints returned via pointers.
// Returns payload byte count (or -1 if cap too small / error).
int64_t xtc_encode(const float* coords, int64_t natoms, float precision,
                   int32_t minint[3], int32_t maxint[3],
                   int32_t* smallidx_out, uint8_t* out, int64_t cap) {
    std::vector<int32_t> q((size_t)natoms * 3);
    minint[0] = minint[1] = minint[2] = INT32_MAX;
    maxint[0] = maxint[1] = maxint[2] = INT32_MIN;
    int64_t mindiff = INT64_MAX;
    int32_t oldl[3] = {0, 0, 0};
    for (int64_t i = 0; i < natoms * 3; i++) {
        float v = coords[i] * precision;
        int32_t iv = (int32_t)((v >= 0) ? v + 0.5f : v - 0.5f);
        q[i] = iv;
        int ax = (int)(i % 3);
        if (iv < minint[ax]) minint[ax] = iv;
        if (iv > maxint[ax]) maxint[ax] = iv;
        if (ax == 2) {
            int64_t a = (int64_t)i / 3;
            int64_t diff = llabs((int64_t)q[i - 2] - oldl[0]) +
                           llabs((int64_t)q[i - 1] - oldl[1]) +
                           llabs((int64_t)q[i] - oldl[2]);
            if (a > 0 && diff < mindiff) mindiff = diff;
            oldl[0] = q[i - 2];
            oldl[1] = q[i - 1];
            oldl[2] = q[i];
        }
    }
    uint32_t sizeint[3];
    int bitsizeint[3] = {0, 0, 0};
    int bitsize;
    for (int i = 0; i < 3; i++)
        sizeint[i] = (uint32_t)(maxint[i] - minint[i]) + 1;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        bitsizeint[0] = sizeofint(sizeint[0]);
        bitsizeint[1] = sizeofint(sizeint[1]);
        bitsizeint[2] = sizeofint(sizeint[2]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    // adaptive small-number ladder seeded from the minimum neighbor
    // distance (goes into the frame header for the decoder)
    int smallidx = FIRSTIDX;
    while (smallidx < LASTIDX && MAGICINTS[smallidx] < mindiff)
        smallidx++;
    *smallidx_out = smallidx;
    int maxidx = (LASTIDX < smallidx + 8) ? LASTIDX : smallidx + 8;
    int minidx = maxidx - 8;
    int64_t larger = MAGICINTS[maxidx] / 2;
    int tmpidx = (smallidx - 1 > FIRSTIDX) ? smallidx - 1 : FIRSTIDX;
    int32_t smaller = MAGICINTS[tmpidx] / 2;
    int32_t smallnum = MAGICINTS[smallidx] / 2;
    uint32_t sizesmall[3];
    sizesmall[0] = sizesmall[1] = sizesmall[2] =
        (uint32_t)MAGICINTS[smallidx];

    BitWriter w;
    w.out.reserve((size_t)natoms * 12);
    int32_t prevcoord[3] = {0, 0, 0};
    uint32_t tmpcoord[8 * 3];
    int prevrun = -1;
    int64_t i = 0;
    while (i < natoms) {
        int is_small = 0;
        int is_smaller;
        int32_t* thiscoord = q.data() + (size_t)i * 3;
        if (smallidx < maxidx && i >= 1 &&
            labs(thiscoord[0] - prevcoord[0]) < larger &&
            labs(thiscoord[1] - prevcoord[1]) < larger &&
            labs(thiscoord[2] - prevcoord[2]) < larger) {
            is_smaller = 1;
        } else if (smallidx > minidx) {
            is_smaller = -1;
        } else {
            is_smaller = 0;
        }
        if (i + 1 < natoms) {
            int32_t* next = thiscoord + 3;
            if (labs(thiscoord[0] - next[0]) < smallnum &&
                labs(thiscoord[1] - next[1]) < smallnum &&
                labs(thiscoord[2] - next[2]) < smallnum) {
                // water-pair optimization: swap the seed with its
                // neighbor so the pair encodes as seed + tiny delta
                // (the decoder swaps back on the run's first triple)
                for (int d = 0; d < 3; d++) {
                    int32_t t = thiscoord[d];
                    thiscoord[d] = next[d];
                    next[d] = t;
                }
                is_small = 1;
            }
        }
        uint32_t nums[3] = {
            (uint32_t)(thiscoord[0] - minint[0]),
            (uint32_t)(thiscoord[1] - minint[1]),
            (uint32_t)(thiscoord[2] - minint[2]),
        };
        if (bitsize == 0) {
            w.put(nums[0], bitsizeint[0]);
            w.put(nums[1], bitsizeint[1]);
            w.put(nums[2], bitsizeint[2]);
        } else {
            sendints(w, 3, bitsize, sizeint, nums);
        }
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];
        i++;
        thiscoord = q.data() + (size_t)i * 3;

        int run = 0;
        if (is_small == 0 && is_smaller == -1) is_smaller = 0;
        while (is_small && run < 8 * 3) {
            if (is_smaller == -1 &&
                ((int64_t)(thiscoord[0] - prevcoord[0]) *
                     (thiscoord[0] - prevcoord[0]) +
                 (int64_t)(thiscoord[1] - prevcoord[1]) *
                     (thiscoord[1] - prevcoord[1]) +
                 (int64_t)(thiscoord[2] - prevcoord[2]) *
                     (thiscoord[2] - prevcoord[2])) >=
                    (int64_t)smaller * smaller) {
                is_smaller = 0;  // delta too big for a shrunk ladder
            }
            tmpcoord[run++] =
                (uint32_t)(thiscoord[0] - prevcoord[0] + smallnum);
            tmpcoord[run++] =
                (uint32_t)(thiscoord[1] - prevcoord[1] + smallnum);
            tmpcoord[run++] =
                (uint32_t)(thiscoord[2] - prevcoord[2] + smallnum);
            prevcoord[0] = thiscoord[0];
            prevcoord[1] = thiscoord[1];
            prevcoord[2] = thiscoord[2];
            i++;
            thiscoord = q.data() + (size_t)i * 3;
            is_small = 0;
            if (i < natoms &&
                labs(thiscoord[0] - prevcoord[0]) < smallnum &&
                labs(thiscoord[1] - prevcoord[1]) < smallnum &&
                labs(thiscoord[2] - prevcoord[2]) < smallnum) {
                is_small = 1;
            }
        }
        if (run != prevrun || is_smaller != 0) {
            prevrun = run;
            w.put(1, 1);
            w.put((uint32_t)(run + is_smaller + 1), 5);
        } else {
            w.put(0, 1);
        }
        for (int k = 0; k < run; k += 3) {
            sendints(w, 3, smallidx, sizesmall, &tmpcoord[k]);
        }
        if (is_smaller != 0) {
            smallidx += is_smaller;
            if (is_smaller < 0) {
                smallnum = smaller;
                if (smallidx > FIRSTIDX)
                    smaller = MAGICINTS[smallidx - 1] / 2;
                else
                    smaller = 0;
            } else {
                smaller = smallnum;
                smallnum = MAGICINTS[smallidx] / 2;
            }
            sizesmall[0] = sizesmall[1] = sizesmall[2] =
                (uint32_t)MAGICINTS[smallidx];
        }
    }
    w.flush();
    if ((int64_t)w.out.size() > cap) return -1;
    std::memcpy(out, w.out.data(), w.out.size());
    return (int64_t)w.out.size();
}

}  // extern "C"
