// PNG row unfiltering on the host (PNG spec, section 9: filter method 0).
//
// raw holds `rows` scanlines, each its filter-type byte followed by `stride`
// filtered bytes; out receives rows x stride reconstructed bytes. bpp is the
// number of bytes of one complete pixel (the distance of the byte to the
// left that Sub, Average and Paeth predict from). Returns 0, or 1 when a row
// has a filter type other than 0..4 (out is then incomplete).
#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* raw, uint8_t* out, int rows, int stride, int bpp) {
    for (int r = 0; r < rows; ++r) {
        const uint8_t* in = raw + (size_t)r * (stride + 1);
        const int type = in[0];
        ++in;
        uint8_t* x = out + (size_t)r * stride;
        const uint8_t* up = r ? x - stride : nullptr;
        switch (type) {
        case 0:
            for (int i = 0; i < stride; ++i) x[i] = in[i];
            break;
        case 1:
            for (int i = 0; i < stride; ++i) x[i] = in[i] + (i >= bpp ? x[i - bpp] : 0);
            break;
        case 2:
            for (int i = 0; i < stride; ++i) x[i] = in[i] + (up ? up[i] : 0);
            break;
        case 3:
            for (int i = 0; i < stride; ++i) {
                const int a = i >= bpp ? x[i - bpp] : 0, b = up ? up[i] : 0;
                x[i] = in[i] + ((a + b) >> 1);
            }
            break;
        case 4:
            for (int i = 0; i < stride; ++i) {
                const int a = i >= bpp ? x[i - bpp] : 0, b = up ? up[i] : 0;
                const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
                x[i] = in[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
            }
            break;
        default:
            return 1;
        }
    }
    return 0;
}
