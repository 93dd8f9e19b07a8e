// Native streamline rasterizer.
//
// The reference rasterizes streamline segments on the CPU with a
// thickness-expanded Bresenham walk (DrawLineSegmentsToTexture /
// DrawBresenhamLine, Assets/Scripts/FluidSim.cs:1765-1849) because
// scattered pixel writes race under its job system.  This is the
// native-runtime equivalent for this engine: the hot voxel path stays
// on device; the final 2D overlay pass — inherently scatter-heavy and
// tiny — runs here at memory speed instead of in Python.
//
// Built as a plain C ABI shared object (no pybind11); see Makefile.
// fluidsim_tpu/render/streamlines.py loads it via ctypes with a NumPy
// fallback of identical semantics.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// segments: n_segments rows of (x0, y0, x1, y1); rows with x0 < 0 are
// skipped ("null" segments, FluidSim.cs:1744-1748).
// rgba: size*size*4 floats, row-major [y][x][c]; color: 4 floats.
void draw_segments(const float* segments, int n_segments, float* rgba,
                   const float* color, int size, float thickness) {
    const int half_thick = static_cast<int>(std::floor(thickness / 2.0f));

    for (int s = 0; s < n_segments; ++s) {
        const float* seg = segments + 4 * s;
        if (seg[0] < 0.0f) continue;

        int x0 = static_cast<int>(seg[0]);
        int y0 = static_cast<int>(seg[1]);
        int x1 = static_cast<int>(std::lround(seg[2]));
        int y1 = static_cast<int>(std::lround(seg[3]));

        const bool steep = std::abs(y1 - y0) > std::abs(x1 - x0);
        if (steep) {
            std::swap(x0, y0);
            std::swap(x1, y1);
        }
        if (x0 > x1) {
            std::swap(x0, x1);
            std::swap(y0, y1);
        }

        const int dx = x1 - x0;
        const int dy = std::abs(y1 - y0);
        int error = dx / 2;
        int y = y0;
        const int ystep = (y0 < y1) ? 1 : -1;

        for (int x = x0; x <= x1; ++x) {
            for (int tx = -half_thick; tx <= half_thick; ++tx) {
                for (int ty = -half_thick; ty <= half_thick; ++ty) {
                    const int draw_x = (steep ? y : x) + tx;
                    const int draw_y = (steep ? x : y) + ty;
                    if (draw_x >= 0 && draw_x < size &&
                        draw_y >= 0 && draw_y < size) {
                        float* px = rgba + 4 * (draw_x + draw_y * size);
                        std::memcpy(px, color, 4 * sizeof(float));
                    }
                }
            }
            error -= dy;
            if (error < 0) {
                y += ystep;
                error += dx;
            }
        }
    }
}

// Alpha-over composite of the streamline overlay onto the fluid frame:
// overlay pixels with a > 0 replace the base (CombineTextures,
// FluidSim.cs:868-884).
void composite_over(float* base_rgba, const float* overlay_rgba, int n_px) {
    for (int i = 0; i < n_px; ++i) {
        if (overlay_rgba[4 * i + 3] > 0.0f) {
            std::memcpy(base_rgba + 4 * i, overlay_rgba + 4 * i,
                        4 * sizeof(float));
        }
    }
}

}  // extern "C"
