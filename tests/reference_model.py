"""Executable numpy model of the reference's algorithms, used as a test oracle.

This is a literal re-statement (in plain numpy, from the SURVEY's math
derivation) of what the OpenCL kernels compute — ring pointers, packing
conventions, bin-0 componentwise products, /parts normalization and all —
so the JAX engines can be checked against the reference's *behavior*
without OpenCL hardware. Citations refer to /root/reference files.
"""

from __future__ import annotations

import numpy as np


def fwd_unnorm(z: np.ndarray) -> np.ndarray:
    """Unnormalized forward DFT (pconv fft kernel, cl_conv_kernels.h:54-68)."""
    return np.fft.fft(z)


def inv_unnorm(z: np.ndarray) -> np.ndarray:
    """Unnormalized inverse DFT (sum convention)."""
    return np.fft.ifft(z) * len(z)


def ref_pack(c: np.ndarray) -> np.ndarray:
    """Literal `r2c`/`conv` kernel (cl_fft.cpp:178-191): pairwise loop over
    i in [1, M/2), bin0 packs (DC/2, Nyq/2), bin M/2 untouched."""
    m = len(c)
    out = c.copy()
    out[0] = complex((c[0].real + c[0].imag) * 0.5, (c[0].real - c[0].imag) * 0.5)
    w = np.exp(-1j * np.pi * np.arange(m) / m)
    for i in range(1, m // 2):
        j = m - i
        cj = np.conj(c[j])
        e = 0.5 * (c[i] + cj)
        o = 0.5j * (cj - c[i])
        p = w[i] * o
        out[i] = e + p
        out[j] = np.conj(e - p)
    return out


def ref_unpack(c: np.ndarray) -> np.ndarray:
    """Literal `c2r`/`iconv` kernel (cl_fft.cpp:192-205): bin0 has no 0.5."""
    m = len(c)
    out = c.copy()
    out[0] = complex(c[0].real + c[0].imag, c[0].real - c[0].imag)
    w = np.exp(+1j * np.pi * np.arange(m) / m)
    for i in range(1, m // 2):
        j = m - i
        cj = np.conj(c[j])
        e = 0.5 * (c[i] + cj)
        o = 0.5j * (c[i] - cj)
        p = w[i] * o
        out[i] = e + p
        out[j] = np.conj(e - p)
    return out


def _analyze(block: np.ndarray, pts: int) -> np.ndarray:
    """Zero-padded forward rfft of one partition, unnormalized + packed."""
    frame = np.zeros(2 * pts, np.float64)
    frame[: len(block)] = block
    z = frame[0::2] + 1j * frame[1::2]
    return ref_pack(fwd_unnorm(z))


class RefPconv:
    """Literal model of Clpconv (cl_conv.cpp:140-548)."""

    def __init__(self, cvs: int, pts: int):
        assert cvs % pts == 0
        self.pts = pts
        self.nparts = cvs // pts
        self.spec1 = np.zeros((self.nparts, pts), np.complex128)
        self.spec2 = np.zeros((self.nparts, pts), np.complex128)
        self.tail = np.zeros(pts, np.float64)
        self.wp = 0
        self.wp2 = self.nparts - 1

    def push_ir(self, ir: np.ndarray) -> None:
        """cl_conv.cpp:353-388: partitions written at wp2, wp2 decrementing."""
        for i in range(self.nparts):
            self.spec2[self.wp2] = _analyze(ir[i * self.pts:(i + 1) * self.pts],
                                            self.pts)
            self.wp2 = self.nparts - 1 if self.wp2 == 0 else self.wp2 - 1

    def _convol_and_ola(self) -> np.ndarray:
        """`convol` kernel (cl_conv_kernels.h:102-118) + inverse + `olap`."""
        np_, pts = self.nparts, self.pts
        acc = np.zeros(pts, np.complex128)
        for q in range(np_):
            rp = self.wp + q
            src = self.spec1[rp if rp < np_ else rp - np_]
            prod = src * self.spec2[q]
            prod[0] = complex(src[0].real * self.spec2[q][0].real,
                              src[0].imag * self.spec2[q][0].imag)
            acc += prod
        z = inv_unnorm(ref_unpack(acc))
        y = np.zeros(2 * pts, np.float64)
        y[0::2], y[1::2] = z.real, z.imag
        out = (y[:pts] + self.tail) / pts              # cl_conv_kernels.h:122
        self.tail = y[pts:].copy()
        return out

    def convolution(self, block: np.ndarray) -> np.ndarray:
        """LTI hot path, cl_conv.cpp:393-458."""
        self.spec1[self.wp] = _analyze(block, self.pts)
        self.wp = self.wp + 1 if self.wp != self.nparts - 1 else 0
        return self._convol_and_ola()

    def convolution_tv(self, b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
        """Time-varying path, cl_conv.cpp:460-548."""
        self.spec1[self.wp] = _analyze(b1, self.pts)
        self.spec2[self.wp2] = _analyze(b2, self.pts)
        self.wp = self.wp + 1 if self.wp != self.nparts - 1 else 0
        self.wp2 = self.nparts - 1 if self.wp2 == 0 else self.wp2 - 1
        return self._convol_and_ola()


class RefDconv:
    """Literal model of Cldconv (cl_dconv.cpp), with correct wrap byte counts
    (the reference's short-read-after-wrap artifact Q3 is not modeled)."""

    def __init__(self, irsize: int, vsize: int):
        self.irsize, self.vsize = irsize, vsize
        self.end = irsize + vsize
        self.dl = np.zeros(self.end, np.float64)
        self.coefs = np.zeros(self.end, np.float64)
        self.wp = 0

    def push_ir(self, ir: np.ndarray) -> None:
        self.coefs[: self.irsize] = ir

    def convolution(self, block: np.ndarray) -> np.ndarray:
        for n in range(self.vsize):
            self.dl[(self.wp + n) % self.end] = block[n]
        self.wp = (self.wp + self.vsize) % self.end    # cl_dconv.cpp:124
        out = np.zeros(self.vsize, np.float64)
        for n in range(self.vsize):                    # cl_dconv.cpp:32-43
            for h in range(self.irsize):
                rp = self.wp + n + h
                rp = rp if rp < self.end else rp % self.end
                out[n] += self.dl[rp] * self.coefs[self.irsize - 1 - h]
        return out

    def convolution_tv(self, b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
        for n in range(self.vsize):                    # cl_dconv.cpp:134-148
            self.coefs[(self.wp + n) % self.end] = b2[n]
        return self.convolution(b1)
