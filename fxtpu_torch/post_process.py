"""Post-processing: visualization and the TEST-mode fringe-model fit.

Feature parity with the reference ``post_process.py`` (229 LoC,
``effex/post_process.py``):

  * :func:`visualize` — continuum/test: 2x2 panels of amplitude,
    real+imag, phase, imag (x axis in delay-ns when a sweep step is known);
    spectrum: 2x2 pcolormesh waterfalls vs RF frequency with phase clim
    +/-pi and <=50 plotted rows (``post_process.py:7-99``);
  * :func:`fit_interferometer_model` — squared sinc fringe-envelope fit
    (Thompson/Moran/Swenson Eq. 2.4 in delay form,
    ``post_process.py:102-147``) — here it *returns* the fitted parameters
    so TEST-mode validation is automatable (an explicit SURVEY.md §4 gap:
    the reference's fringe check was manual);
  * :func:`post_process` driver and a standalone CLI
    (``post_process.py:150-228``) — the sweep step is read from the CSV
    header instead of being reconstructed with the wrong magic constant
    (``post_process.py:213-215`` used (1/fc)/10 while the live code used
    (1/fc)/2; SURVEY.md §2.4).

Plots are optional everywhere (figures can be saved or suppressed) so the
whole module is CI-safe with a non-interactive matplotlib backend.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np

from fxtpu_torch.products import load_products, shifted_rf_freqs

C_LIGHT = 2.998e8  # m/s, reference constant (post_process.py:110,120)


def _plt():
    import matplotlib
    import matplotlib.pyplot as plt
    return plt


def visualize(visibilities, rate, fc, nfft, mode, test_delay_sweep_step=0,
              save: Optional[str] = None, show: bool = True):
    """2x2 panel figure of one product file (``post_process.py:7-99``)."""
    plt = _plt()
    visibilities = np.asarray(visibilities)
    if mode.lower() not in ("continuum", "test"):
        # a single-spectrum product loads 1-D (np.loadtxt squeezes);
        # the waterfall panels index [row, bin]
        visibilities = np.atleast_2d(visibilities)
    amp = np.sqrt(np.real(visibilities * np.conj(visibilities)))
    phase = np.angle(visibilities)
    real_part = np.real(visibilities)
    imag_part = np.imag(visibilities)

    mode = mode.lower()
    sharey = "none" if mode in ("continuum", "test") else "all"
    fig, axes = plt.subplots(nrows=2, ncols=2, sharex="all", sharey=sharey)

    if mode in ("continuum", "test"):
        samples = np.arange(len(amp))
        if test_delay_sweep_step:
            x = samples * test_delay_sweep_step * 1e9
            xlabel = "Delay (ns)"
        else:
            x = samples
            xlabel = "Sample #"
        axes[0][0].plot(x, amp)
        axes[0][0].set_xlabel(xlabel)
        axes[0][0].set_ylabel("Amplitude (uncalibrated)")
        axes[0][0].set_title("Complex Cross-Correlation Amplitude")
        axes[0][1].plot(x, real_part, label="real part")
        axes[0][1].plot(x, imag_part, alpha=0.5, label="imag_part")
        axes[0][1].set_xlabel(xlabel)
        axes[0][1].set_ylabel("Amplitude")
        axes[0][1].set_title("Complex Cross-Correlation Real & Imag")
        axes[0][1].legend(loc="best")
        axes[1][0].plot(x, phase)
        axes[1][0].set_xlabel(xlabel)
        axes[1][0].set_ylabel("Phase")
        axes[1][0].set_title("Complex Cross-Correlation Phase")
        axes[1][1].plot(x, imag_part, label="imag_part")
        axes[1][1].set_xlabel(xlabel)
        axes[1][1].set_ylabel("Amplitude")
        axes[1][1].set_title("Complex Cross-Correlation Imag")
    else:
        freqs = shifted_rf_freqs(nfft, rate, fc)
        num_spectra = np.arange(visibilities.shape[0])
        stride = 1
        max_rows = 50
        if num_spectra.max() > max_rows:
            stride = int(num_spectra.max()) // max_rows
        xg, yg = np.meshgrid(freqs, num_spectra[::stride])
        panels = [
            (amp, "Complex Cross-Correlation Amplitude", axes[0][0], None),
            (real_part, "Real part of XCorrs", axes[0][1], None),
            (phase, "Complex Cross-Correlation Phase", axes[1][0],
             (-np.pi, np.pi)),
            (imag_part, "Imag part of XCorrs", axes[1][1], None),
        ]
        for data, title, ax, clim in panels:
            im = ax.pcolormesh(xg, yg, data[::stride, :], shading="auto",
                               cmap="viridis")
            if clim:
                im.set_clim(*clim)
            ax.set_xlabel("Frequency (Hz)")
            ax.set_ylabel("Sample #")
            ax.set_title(title)
            fig.colorbar(im, ax=ax)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig


def fringe_fitfunc(tau, amp, tau0, dnu, slope):
    """Squared sinc fringe envelope in delay form (TMS Eq. 2.4;
    ``post_process.py:115-123``)."""
    f = np.sinc(np.pi * (tau + tau0) * dnu)
    return (amp * f + slope * tau) ** 2


def fit_interferometer_model(raw_output, delay_step, bandwidth, center_freq,
                             tau0_seed: float = 5.84e-8,
                             save: Optional[str] = None, show: bool = True
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Fit the fringe envelope to a TEST-mode delay sweep
    (``post_process.py:102-147``).  Returns ``(pfit, pcov)`` with
    ``pfit = [amp, tau0, dnu, slope]`` so tests can assert recovered
    parameters (automated physics oracle)."""
    from scipy.optimize import curve_fit

    visibilities = np.asarray(raw_output)
    amp = np.sqrt(np.real(visibilities * np.conj(visibilities)))
    samples = np.arange(-len(amp) // 2, len(amp) // 2)
    delay = samples * delay_step
    p0 = [np.max(amp) ** 0.5, tau0_seed, bandwidth, 0]
    pfit, pcov = curve_fit(fringe_fitfunc, delay, amp, p0, maxfev=10000)

    if save or show:
        plt = _plt()
        fig, ax = plt.subplots()
        ax.plot(delay, amp, label="measurement")
        ax.plot(delay, fringe_fitfunc(delay, *pfit), label="sinc envelope fit")
        ax.set_xlabel("Delay (s)")
        ax.set_ylabel("Amplitude (adu)")
        ax.legend()
        if save:
            fig.savefig(save, dpi=120)
        if show:
            plt.show()
        else:
            plt.close(fig)
    return pfit, pcov


def fringe_envelope(tau, amp, tau0, dnu):
    """Physically-correct fringe amplitude envelope: ``A |sinc(dnu (tau+tau0))|``
    (numpy sinc convention).  The reference's :func:`fringe_fitfunc` squares
    the envelope and double-counts pi inside ``np.sinc``; this model is what
    the measured continuum amplitude actually follows, and recovers
    ``dnu == bandwidth`` to <1% on synthetic sweeps (the automated TEST
    oracle in tests/test_fringe.py)."""
    return amp * np.abs(np.sinc(dnu * (tau + tau0)))


def fit_fringe_envelope(raw_output, delay_step, bandwidth,
                        offset_steps: Optional[int] = None):
    """Fit :func:`fringe_envelope` to a TEST-mode sweep.  ``offset_steps``
    centers the delay axis at the true sweep zero when known (the sweep
    starts at ``-offset_steps*delay_step``); otherwise the axis is centered
    like the reference fit.  Returns ``(pfit, pcov)`` with
    ``pfit = [amp, tau0, dnu]``."""
    from scipy.optimize import curve_fit

    amp = np.abs(np.asarray(raw_output))
    n = len(amp)
    if offset_steps is not None:
        samples = np.arange(n) + 1 - offset_steps
    else:
        samples = np.arange(-n // 2, n // 2)
    tau = samples * delay_step
    p0 = [amp.max(), 0.0, bandwidth]
    return curve_fit(fringe_envelope, tau, amp, p0, maxfev=20000)


def post_process(raw_output, rate, fc, nfft, mode, omit_plot,
                 test_delay_sweep_step=0, save: Optional[str] = None,
                 show: bool = True):
    """Driver (``post_process.py:150-184``): visualize, plus the fringe fit
    in TEST mode.  Returns the fit params (or None)."""
    pfit = None
    if not omit_plot:
        visualize(raw_output, rate, fc, nfft, mode,
                  test_delay_sweep_step=test_delay_sweep_step,
                  save=save, show=show)
    if mode.lower() == "test":
        fit_save = (save.replace(".png", "_fit.png") if save else None)
        pfit, _ = fit_interferometer_model(
            raw_output, test_delay_sweep_step, rate, fc,
            save=fit_save, show=(show and not omit_plot))
    return pfit


def main(argv=None):
    """Standalone CLI: re-plot an existing product CSV
    (``post_process.py:187-228``)."""
    parser = argparse.ArgumentParser(
        description="Pull data from an fxtpu/effex-generated .csv file and "
                    "post-process it. Shows a plot.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("filename", type=str,
                        help="(str) output visibilities .csv file")
    parser.add_argument("--save", type=str, default=None,
                        help="save figures to this path instead of only showing")
    parser.add_argument("--no-show", action="store_true",
                        help="don't open interactive windows")
    args = parser.parse_args(argv)

    metadata, output = load_products(args.filename)
    mode = metadata["mode"].lower()
    # Sweep step comes from the header when present (written by fxtpu);
    # fall back to the live-code constant (1/fc)/2 for reference-written
    # TEST files (effex.py:154).
    if mode == "test":
        step = float(metadata.get(
            "sweep_step", (1 / float(metadata["frequency"])) / 2.0))
    else:
        step = 0

    post_process(output,
                 float(metadata["bandwidth"]),
                 float(metadata["frequency"]),
                 int(metadata["resolution"]),
                 mode,
                 False,
                 test_delay_sweep_step=step,
                 save=args.save,
                 show=not args.no_show)


if __name__ == "__main__":
    main()
