"""Per-op unit tests: octproz_tpu.ops vs the NumPy oracle (tests/oracle.py)."""

import numpy as np
import pytest

import oracle
from octproz_tpu import AcqParams, Interpolation
from octproz_tpu.ops import (background, convert, dispersion, fft, fpn,
                             postprocess, projections, quantize, resample)

import jax.numpy as jnp


class TestConvert:
    @pytest.mark.parametrize("bit_depth,dtype,hi", [
        (8, np.uint8, 255), (12, np.uint16, 4095), (16, np.uint16, 65535),
        (32, np.uint32, 2**32 - 1),
    ])
    def test_decode(self, rng, bit_depth, dtype, hi):
        raw = rng.integers(0, hi, size=(3, 5, 16), dtype=dtype)
        got = np.asarray(convert.decode(jnp.asarray(raw), bit_depth, False))
        want = oracle.decode(raw, bit_depth, False)
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-6)

    @pytest.mark.parametrize("bit_depth,dtype,hi", [
        (12, np.uint16, 4095), (16, np.uint16, 65535), (32, np.uint32, 2**32 - 1),
    ])
    def test_decode_bitshift(self, rng, bit_depth, dtype, hi):
        raw = rng.integers(0, hi, size=(64,), dtype=dtype)
        got = np.asarray(convert.decode(jnp.asarray(raw), bit_depth, True))
        want = oracle.decode(raw, bit_depth, True)
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-6)

    def test_unpack_uint12(self):
        samples = np.array([0x123, 0xABC, 0xFFF, 0x000, 0x801], dtype=np.uint16)
        packed = []
        for i in range(0, len(samples) + 1, 2):
            pair = samples[i:i + 2]
            if len(pair) == 0:
                break
            s0 = int(pair[0])
            s1 = int(pair[1]) if len(pair) > 1 else 0
            packed += [s0 & 0xFF, ((s0 >> 8) & 0x0F) | ((s1 & 0x0F) << 4), (s1 >> 4) & 0xFF]
        got = convert.unpack_uint12_packed(np.array(packed, np.uint8), len(samples))
        np.testing.assert_array_equal(got, samples)


class TestBackground:
    @pytest.mark.parametrize("window", [1, 3, 16, 200])
    def test_vs_oracle(self, rng, window):
        x = rng.normal(size=(2, 4, 64)).astype(np.float32)
        got = np.asarray(background.remove_background(jnp.asarray(x), window))
        want = oracle.rolling_background(x, window)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class TestResample:
    N = 128

    def _curve(self, rng, lo=0.0, hi=None):
        hi = self.N - 3 if hi is None else hi
        return np.sort(rng.uniform(lo, hi, self.N)).astype(np.float32)

    @pytest.mark.parametrize("mode", ["linear", "quadratic", "cubic"])
    def test_matrix_vs_oracle(self, rng, mode):
        curve = self._curve(rng)
        x = rng.normal(size=(3, 7, self.N)).astype(np.float32)
        m = resample.build_resample_matrix(curve, Interpolation(mode))
        got = np.asarray(resample.apply_matmul(jnp.asarray(x), jnp.asarray(m)))
        want = oracle.resample(x, curve, mode)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    def test_lanczos_matrix_vs_oracle_interior(self, rng):
        # away from edges the edge-clamp is inactive; oracle and matrix agree
        curve = self._curve(rng, lo=8.0, hi=self.N - 10)
        x = rng.normal(size=(2, 3, self.N)).astype(np.float32)
        m = resample.build_resample_matrix(curve, Interpolation.LANCZOS)
        got = np.asarray(resample.apply_matmul(jnp.asarray(x), jnp.asarray(m)))
        want = oracle.resample(x, curve, "lanczos")
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    def test_lanczos_edge_semantics_no_cross_line_bleed(self, rng):
        """Pins the documented deviation from the reference (parity.md,
        ops/resample.py:27-33): near-edge curve values use per-tap edge
        replication WITHIN the A-scan.  Two consequences the reference's
        flat-buffer offset clamp (cuda_code.cu:313) violates: (1) the first
        A-scan of a buffer resamples exactly like every other A-scan — no
        reads bleed into the neighboring line; (2) near-edge outputs are a
        clamped-tap weighted sum over the line's own samples."""
        curve = np.clip(self._curve(rng), 0.0, self.N - 3)
        curve[:4] = [0.0, 1.5, 3.0, 6.0]          # within 7 of the left edge
        curve[-3:] = [self.N - 9.5, self.N - 4, self.N - 3]  # right edge
        m = resample.build_resample_matrix(curve, Interpolation.LANCZOS)
        # same line content placed at different A-scan rows gives identical
        # output rows: the operator never indexes outside the line
        line = rng.normal(size=self.N).astype(np.float32)
        x = np.stack([line, rng.normal(size=self.N).astype(np.float32), line])
        got = np.asarray(resample.apply_matmul(jnp.asarray(x), jnp.asarray(m)))
        np.testing.assert_array_equal(got[0], got[2])
        # explicit oracle: taps clamped to [0, N-1] (edge replication)
        idx, w = resample.interpolation_taps(curve, Interpolation.LANCZOS)
        want = (line[np.clip(idx, 0, self.N - 1)] * w).sum(axis=1)
        np.testing.assert_allclose(got[0], want, rtol=2e-4, atol=2e-4)
        # a constant line stays constant to within the truncated-sinc
        # kernel's intrinsic ripple (the weights don't sum exactly to 1;
        # the reference doesn't renormalize either, cuda_code.cu:297-326)
        const = np.full((1, self.N), 2.5, np.float32)
        got_c = np.asarray(resample.apply_matmul(jnp.asarray(const), jnp.asarray(m)))
        np.testing.assert_allclose(got_c, 2.5, rtol=2e-3)

    @pytest.mark.parametrize("mode", list(Interpolation))
    def test_gather_vs_matrix(self, rng, mode):
        curve = self._curve(rng, lo=8.0, hi=self.N - 10)
        x = rng.normal(size=(4, self.N)).astype(np.float32)
        m = resample.build_resample_matrix(curve, mode)
        via_matrix = np.asarray(resample.apply_matmul(jnp.asarray(x), jnp.asarray(m)))
        via_gather = np.asarray(resample.apply_gather(jnp.asarray(x), jnp.asarray(curve), mode))
        np.testing.assert_allclose(via_matrix, via_gather, rtol=2e-4, atol=2e-4)

    def test_cubic_edge_trick(self):
        # curve value < 1 exercises n0 = abs(n1 - 1) = 1 aliasing (cuda_code.cu:284)
        curve = np.array([0.5, 0.0], dtype=np.float32)
        x = np.arange(16, dtype=np.float32)[None, :]
        m = resample.build_resample_matrix(curve, Interpolation.CUBIC, n_in=16)
        got = np.asarray(resample.apply_matmul(jnp.asarray(x), jnp.asarray(m)))
        want = oracle.resample(x, curve, "cubic")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_identity_linear(self):
        curve = np.arange(self.N, dtype=np.float32).clip(0, self.N - 3)
        x = np.random.default_rng(0).normal(size=(2, self.N)).astype(np.float32)
        m = resample.build_resample_matrix(curve, Interpolation.LINEAR)
        got = np.asarray(resample.apply_matmul(jnp.asarray(x), jnp.asarray(m)))
        np.testing.assert_allclose(got[:, :self.N - 3], x[:, :self.N - 3], rtol=1e-5)

    def test_matrix_rows_are_tap_weights(self, rng):
        curve = self._curve(rng)
        m = resample.build_resample_matrix(curve, Interpolation.LINEAR)
        np.testing.assert_allclose(m.sum(axis=1), 1.0, atol=1e-5)  # partition of unity


class TestDispersionWindow:
    def test_prep_matches_oracle(self, rng):
        x = rng.normal(size=(2, 3, 32)).astype(np.float32)
        window = rng.uniform(0, 1, 32).astype(np.float32)
        phi = rng.uniform(-3, 3, 32).astype(np.float32)
        phase = np.exp(1j * phi).astype(np.complex64)
        got = np.asarray(dispersion.prep_spectra(jnp.asarray(x), jnp.asarray(window),
                                                 jnp.asarray(phase)))
        want = oracle.prep(x, window, phase)
        np.testing.assert_allclose(got, want.astype(np.complex64), rtol=1e-5, atol=1e-5)

    def test_real_path_stays_real(self, rng):
        x = rng.normal(size=(4, 32)).astype(np.float32)
        window = rng.uniform(0, 1, 32).astype(np.float32)
        out = dispersion.prep_spectra(jnp.asarray(x), jnp.asarray(window), None)
        assert out.dtype == jnp.float32


class TestFFT:
    def test_ifft_unnormalized(self, rng):
        x = (rng.normal(size=(3, 64)) + 1j * rng.normal(size=(3, 64))).astype(np.complex64)
        got = np.asarray(fft.ifft_spectra(jnp.asarray(x)))
        want = oracle.ifft_unnormalized(x)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_rfft_half_path_equals_c2c(self, rng):
        x = rng.normal(size=(5, 64)).astype(np.float32)
        half = 32
        got = np.asarray(fft.ifft_spectra_real_half(jnp.asarray(x), half))
        want = oracle.ifft_unnormalized(x.astype(np.complex128))[..., :half]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class TestFPN:
    def test_min_variance_mean_vs_oracle(self, rng):
        lines = (rng.normal(size=(45, 16)) + 1j * rng.normal(size=(45, 16))).astype(np.complex64)
        got = np.asarray(fpn.minimum_variance_mean(jnp.asarray(lines)))
        want = oracle.min_variance_mean(lines)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)

    def test_remainder_lines_ignored(self, rng):
        # 9 segments of width 5 from 47 lines -> last 2 lines unused
        lines = (rng.normal(size=(47, 8)) + 1j * rng.normal(size=(47, 8))).astype(np.complex64)
        got = np.asarray(fpn.minimum_variance_mean(jnp.asarray(lines)))
        want = np.asarray(fpn.minimum_variance_mean(jnp.asarray(lines[:45])))
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_selection_invariant_under_perturbation(self, rng):
        """The tie-banded argmin (fpn._banded_argmin)
        must pick the SAME segment under numeric perturbations of the size
        the precision rungs introduce (~1e-5 relative, the measured "high"
        split operand error) -- including on near-tied variances, where the
        reference's exact argmin flips chaotically."""
        segs, width = 9, 64
        # near-tied construction: all segments share the same base variance,
        # separated by less than float32 noise in places
        base = rng.normal(size=(segs, width)) * 1e-7 + 1.0
        sum_sq = (base * 40.0).astype(np.float32)          # E|z|^2 * n
        sum_z = (rng.normal(size=(segs, width))
                 + 1j * rng.normal(size=(segs, width))).astype(np.complex64) * 0.1
        ref = np.asarray(fpn.select_min_variance_mean(
            jnp.asarray(sum_z), jnp.asarray(sum_sq), 40))
        for scale in (1 + 1e-5, 1 - 1e-5):
            pert = np.asarray(fpn.select_min_variance_mean(
                jnp.asarray(sum_z), jnp.asarray(sum_sq * scale), 40))
            np.testing.assert_array_equal(pert, ref)
        # planar path agrees with the complex path
        pre, pim = fpn.select_min_variance_mean_planar(
            jnp.asarray(sum_z.real), jnp.asarray(sum_z.imag),
            jnp.asarray(sum_sq), 40)
        np.testing.assert_allclose(np.asarray(pre) + 1j * np.asarray(pim),
                                   ref, rtol=1e-6)

    def test_genuine_minimum_still_wins(self, rng):
        """The band must NOT override a clearly lower-variance segment:
        outside the tie band the selection equals the exact argmin."""
        segs, width = 9, 32
        sum_sq = np.full((segs, width), 100.0, np.float32)
        sum_sq[4] = 50.0  # segment 4 has clearly the lowest variance
        sum_z = np.zeros((segs, width), np.complex64)
        sum_z[4] = 3.0 + 1.0j
        got = np.asarray(fpn.select_min_variance_mean(
            jnp.asarray(sum_z), jnp.asarray(sum_sq), 10))
        np.testing.assert_allclose(got, np.full(width, 0.3 + 0.1j), rtol=1e-6)

    def test_constant_pattern_removed(self, rng):
        # a constant additive line is the minimum-variance segment mean everywhere
        pattern = (rng.normal(size=16) + 1j * rng.normal(size=16)).astype(np.complex64)
        signal = (0.01 * (rng.normal(size=(45, 16)) + 1j * rng.normal(size=(45, 16)))).astype(np.complex64)
        lines = signal + pattern
        mean = fpn.minimum_variance_mean(jnp.asarray(lines))
        cleaned = np.asarray(fpn.subtract_mean_line(jnp.asarray(lines), mean))
        assert np.abs(cleaned).mean() < 0.1 * np.abs(pattern).mean()


class TestPostprocess:
    def test_truncate_log(self, rng):
        z = (rng.normal(size=(2, 3, 64)) + 1j * rng.normal(size=(2, 3, 64))).astype(np.complex64)
        got = np.asarray(postprocess.scale_log(
            postprocess.truncate_half(jnp.asarray(z)), 32, 0.0, 60.0, 0.0, 1.0))
        want = oracle.truncate_log(z, 0.0, 60.0, 0.0, 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_truncate_lin(self, rng):
        z = (rng.normal(size=(2, 3, 64)) + 1j * rng.normal(size=(2, 3, 64))).astype(np.complex64)
        got = np.asarray(postprocess.scale_lin(
            postprocess.truncate_half(jnp.asarray(z)), 32, 0.0, 2.0, 0.1, 0.5))
        want = oracle.truncate_lin(z, 0.0, 2.0, 0.1, 0.5)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_bscan_flip(self, rng):
        v = rng.normal(size=(4, 6, 8)).astype(np.float32)
        got = np.asarray(postprocess.bscan_flip(jnp.asarray(v)))
        np.testing.assert_allclose(got, oracle.bscan_flip(v), rtol=1e-6)

    def test_sinusoidal(self, rng):
        v = rng.normal(size=(3, 32, 8)).astype(np.float32)
        from octproz_tpu.curves import sinusoidal_scan_curve
        got = np.asarray(postprocess.sinusoidal_correction(
            jnp.asarray(v), jnp.asarray(sinusoidal_scan_curve(32))))
        want = oracle.sinusoidal_correction(v)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_post_background(self, rng):
        v = rng.uniform(0, 1.5, size=(3, 4, 8)).astype(np.float32)
        bg = np.asarray(postprocess.get_background(jnp.asarray(v)))
        np.testing.assert_allclose(bg, oracle.post_background(v), rtol=1e-5)
        got = np.asarray(postprocess.remove_post_background(
            jnp.asarray(v), jnp.asarray(bg), 0.9, 0.05))
        want = oracle.remove_post_background(v, bg, 0.9, 0.05)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


class TestProjections:
    def test_bscan_frame_avg_mip(self, rng):
        from octproz_tpu import DisplayFunction
        v = rng.normal(size=(8, 4, 6)).astype(np.float32)
        avg = np.asarray(projections.bscan_frame(jnp.asarray(v), 2, 3, DisplayFunction.AVERAGING))
        np.testing.assert_allclose(avg, v[2:5].mean(axis=0), rtol=1e-5)
        mip = np.asarray(projections.bscan_frame(jnp.asarray(v), 6, 4, DisplayFunction.MIP))
        # reference maxValue starts at 0 (cuda_code.cu:841): MIP clamps at 0
        np.testing.assert_allclose(mip, np.maximum(v[6:8].max(axis=0), 0.0),
                                   rtol=1e-5)  # clipped window

    def test_enface_frame(self, rng):
        from octproz_tpu import DisplayFunction
        v = rng.normal(size=(4, 5, 10)).astype(np.float32)
        avg = np.asarray(projections.enface_frame(jnp.asarray(v), 3, 2, DisplayFunction.AVERAGING))
        np.testing.assert_allclose(avg, v[:, :, 3:5].mean(axis=2), rtol=1e-5)


class TestQuantize:
    @pytest.mark.parametrize("bits,scale,dtype", [
        (8, 255, np.uint8), (10, 1023, np.uint16), (12, 4095, np.uint16),
        (16, 65535, np.uint16), (24, 16777215, np.uint32), (32, 4294967040, np.uint32),
    ])
    def test_scales(self, bits, scale, dtype):
        x = jnp.asarray(np.array([-0.5, 0.0, 0.25, 1.0, 2.0], np.float32))
        got = np.asarray(quantize.quantize(x, bits))
        assert got.dtype == dtype
        expected = (np.clip(np.asarray(x), 0, 1) * scale).astype(np.float32).astype(np.float64).astype(dtype)
        np.testing.assert_array_equal(got, expected)


class TestOracleSelfConsistency:
    def test_vectorized_oracle_resampler_matches_scalar(self, rng):
        """oracle.resample_fast must be bit-equal in math to the scalar
        reference transcription for every interpolation mode (it exists
        only to make full-geometry oracle runs feasible)."""
        import oracle

        n = 96
        curve = np.sort(rng.uniform(0.0, n - 3, n)).astype(np.float32)
        x = rng.normal(size=(5, n))
        for mode in ("linear", "quadratic", "cubic", "lanczos"):
            a = oracle.resample(x, curve, mode)
            b = oracle.resample_fast(x, curve, mode)
            np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-13)


class TestDeviceUnpack:
    def test_device_unpack_matches_native(self, rng):
        from octproz_tpu import native
        from octproz_tpu.ops import convert

        samples = rng.integers(0, 4096, 2048).astype(np.uint16)
        packed = native.pack_uint12(samples)
        got = np.asarray(convert.unpack_uint12_device(
            jnp.asarray(packed), samples.size))
        np.testing.assert_array_equal(got, samples)

    def test_device_unpack_rejects_odd(self):
        from octproz_tpu.ops import convert

        with pytest.raises(ValueError, match="even"):
            convert.unpack_uint12_device(jnp.zeros(3, jnp.uint8), 1)

    @pytest.mark.parametrize("n_samples", [1664 * 3, 1664 * 5 + 2])
    def test_device_unpack_any_even_count(self, rng, n_samples):
        """Counts that are not multiples of 256 take the (N, 3) form on
        every backend (no accelerator refusal)."""
        from octproz_tpu import native
        from octproz_tpu.ops import convert

        samples = rng.integers(0, 4096, n_samples).astype(np.uint16)
        got = np.asarray(convert.unpack_uint12_device(
            jnp.asarray(native.pack_uint12(samples)), n_samples))
        np.testing.assert_array_equal(got, samples)

    def test_put_packed_buffer_native_1664_geometry(self, rng):
        """The dataset's native 1664-sample lines on the packed-12 wire
        through FdOctModel.put_packed_buffer."""
        from octproz_tpu import native
        from octproz_tpu.models.fdoct import FdOctModel
        from octproz_tpu.params import ProcConfig

        acq = AcqParams(samples_per_line=1664, ascans_per_bscan=3,
                        bscans_per_buffer=2, bit_depth=12)
        model = FdOctModel(acq, ProcConfig(fft_via_matmul=True),
                           resample_coeffs=(0.0, 1663.0, 0.0, 0.0))
        raw = rng.integers(0, 4096, acq.buffer_shape).astype(np.uint16)
        got = model.put_packed_buffer(native.pack_uint12(raw.reshape(-1)))
        np.testing.assert_array_equal(np.asarray(got), raw)
        out = model.process_buffer(got)
        assert out.shape == acq.processed_buffer_shape
