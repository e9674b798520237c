/* Trajectory clip stitcher — the host-side data-loader hot loop.
 *
 * The reference's replay sampling stitches random episode clips into
 * fixed-length trajectories in a Python loop over batch elements and clips
 * (reference envs/minipacman.py:139-164).  For host-process environments
 * (ALE / SC2) feeding a device train step, that per-batch Python work sits on
 * the critical path between device steps; this C implementation does the
 * sampling, clip concatenation, and done-flag synthesis in one pass over
 * contiguous arenas.
 *
 * Episodes live in three arenas (frames f32, rewards f32, actions i32)
 * with per-episode offsets/lengths.  For each batch row:
 *   remaining = timesteps
 *   while remaining > 0:
 *     pick a random episode; pick start (0 or random in [0, len-3));
 *     copy min(remaining, len-1-start) steps; mark done=1 at the clip end
 * (exactly the reference's semantics, including the len-1 end cap and the
 * synthetic done at joins).
 *
 * Exposed via ctypes (scmgan_tpu_torch/native/__init__.py):
 *  void stitch(const float *frames, const float *rewards, const int *actions,
 *              const long *ep_offsets, const int *ep_lengths, int n_episodes,
 *              int frame_elems, int reward_elems,
 *              int batch, int timesteps, int random_start, uint64_t seed,
 *              float *out_frames, float *out_rewards, int *out_actions,
 *              unsigned char *out_dones);
 */

#include <stdint.h>
#include <string.h>

/* xorshift64* — deterministic, seedable, no libc rand state */
static inline uint64_t next_rand(uint64_t *s) {
    uint64_t x = *s;
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    *s = x;
    return x * 0x2545F4914F6CDD1DULL;
}

static inline uint32_t rand_below(uint64_t *s, uint32_t n) {
    return (uint32_t)(next_rand(s) % (uint64_t)n);
}

void stitch(const float *frames, const float *rewards, const int *actions,
            const long *ep_offsets, const int *ep_lengths, int n_episodes,
            int frame_elems, int reward_elems,
            int batch, int timesteps, int random_start, uint64_t seed,
            float *out_frames, float *out_rewards, int *out_actions,
            unsigned char *out_dones) {
    uint64_t rng = seed ? seed : 0x9E3779B97F4A7C15ULL;

    for (int b = 0; b < batch; b++) {
        int t = 0;
        int remaining = timesteps;
        int guard = 0;
        while (remaining > 0 && guard++ < 10000) {
            const int e = (int)rand_below(&rng, (uint32_t)n_episodes);
            const int len = ep_lengths[e];
            if (len < 2) continue;
            int start = 0;
            if (random_start && len > 4)
                start = (int)rand_below(&rng, (uint32_t)(len - 3));
            int end = start + remaining;
            if (end > len - 1) end = len - 1;
            const int duration = end - start;
            if (duration <= 0) continue;

            const long base = ep_offsets[e];
            memcpy(out_frames + ((size_t)b * timesteps + t) * frame_elems,
                   frames + (base + start) * (size_t)frame_elems,
                   sizeof(float) * (size_t)duration * frame_elems);
            memcpy(out_rewards + ((size_t)b * timesteps + t) * reward_elems,
                   rewards + (base + start) * (size_t)reward_elems,
                   sizeof(float) * (size_t)duration * reward_elems);
            memcpy(out_actions + (size_t)b * timesteps + t,
                   actions + base + start,
                   sizeof(int) * (size_t)duration);
            for (int d = 0; d < duration - 1; d++)
                out_dones[(size_t)b * timesteps + t + d] = 0;
            out_dones[(size_t)b * timesteps + t + duration - 1] = 1;

            t += duration;
            remaining -= duration;
        }
        /* pad any shortfall (degenerate buffers) with dones */
        for (; t < timesteps; t++) {
            memset(out_frames + ((size_t)b * timesteps + t) * frame_elems, 0,
                   sizeof(float) * (size_t)frame_elems);
            memset(out_rewards + ((size_t)b * timesteps + t) * reward_elems,
                   0, sizeof(float) * (size_t)reward_elems);
            out_actions[(size_t)b * timesteps + t] = 0;
            out_dones[(size_t)b * timesteps + t] = 1;
        }
    }
}
