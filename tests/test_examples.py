"""End-to-end CLI tests (in-process, headless, small t_sim)."""

import os
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "examples"))


def _run_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", argv)
    module.main()
    return capsys.readouterr()


def test_example_cli_host_engine(monkeypatch, capsys):
    import direct_data_driven_mpc_example as ex

    out = _run_main(
        ex,
        [
            "prog",
            "--t_sim",
            "30",
            "--seed",
            "0",
            "--verbose",
            "1",
            "--no_plot",
        ],
        monkeypatch,
        capsys,
    )
    assert "Simulation finished" in out.out


def test_example_cli_fused_engine_matches_host(monkeypatch, capsys):
    import direct_data_driven_mpc_example as ex

    out = _run_main(
        ex,
        [
            "prog",
            "--t_sim",
            "25",
            "--seed",
            "1",
            "--verbose",
            "1",
            "--no_plot",
            "--engine",
            "fused",
        ],
        monkeypatch,
        capsys,
    )
    assert "Simulation finished" in out.out


def test_example_cli_nominal_override(monkeypatch, capsys):
    import direct_data_driven_mpc_example as ex

    out = _run_main(
        ex,
        [
            "prog",
            "--t_sim",
            "20",
            "--seed",
            "0",
            "--verbose",
            "1",
            "--no_plot",
            "--controller_type",
            "Nominal",
            "--n_mpc_step",
            "4",
        ],
        monkeypatch,
        capsys,
    )
    assert "Nominal" in out.out


def test_example_cli_convex_slack(monkeypatch, capsys):
    import direct_data_driven_mpc_example as ex

    out = _run_main(
        ex,
        [
            "prog",
            "--t_sim",
            "15",
            "--seed",
            "0",
            "--verbose",
            "1",
            "--no_plot",
            "--slack_var_const_type",
            "Convex",
        ],
        monkeypatch,
        capsys,
    )
    assert "Simulation finished" in out.out


def test_reproduction_cli(monkeypatch, capsys):
    import robust_data_driven_mpc_reproduction as rep

    out = _run_main(
        rep,
        ["prog", "--t_sim", "40", "--seed", "4", "--verbose", "1",
         "--no_plot"],
        monkeypatch,
        capsys,
    )
    assert "TEC" in out.out
    assert "UCON" in out.out


def test_plotting_produces_figures(tmp_path):
    # Exercise the viz layer: static figure + animation export machinery
    # (figure only; ffmpeg encoding is environment-dependent).
    from direct_data_driven_mpc_jax.viz.plots import (
        create_input_output_figure,
        plot_input_output,
        plot_input_output_animation,
    )

    rng = np.random.default_rng(0)
    u = rng.normal(size=(50, 2))
    y = rng.normal(size=(50, 2))
    fig = plot_input_output(
        u,
        y,
        np.array([[1.0], [1.0]]),
        np.array([[0.65], [0.77]]),
        initial_steps=20,
        show=False,
    )
    assert fig is not None
    path = tmp_path / "static.png"
    fig.savefig(path)
    assert path.stat().st_size > 0

    anim = plot_input_output_animation(
        u,
        y,
        np.array([[1.0], [1.0]]),
        np.array([[0.65], [0.77]]),
        initial_steps=20,
        points_per_frame=10,
    )
    assert anim is not None

    fig2, axs_u, axs_y = create_input_output_figure(m=2, p=2)
    assert len(axs_u) == 2 and len(axs_y) == 2

    import matplotlib.pyplot as plt

    plt.close("all")


def test_monte_carlo_cli(monkeypatch, capsys, tmp_path):
    import monte_carlo_example as mc

    out = _run_main(
        mc,
        [
            "prog", "--batch", "16", "--t_sim", "20", "--seed", "0",
            "--verbose", "1", "--save_fig", str(tmp_path / "mc.png"),
        ],
        monkeypatch,
        capsys,
    )
    assert "spectral radius" in out.out
    assert "Simulated 16 scenarios" in out.out
    assert (tmp_path / "mc.png").stat().st_size > 0


def test_animation_region_labels_appear_with_reveal():
    """Frame-stepping (Agg): the 'Init. Excitation' / 'Init.
    Measurement' region labels start hidden and appear once the
    animated shaded region has grown wide enough to hold them
    (reference data_visualization.py:561-604 behavior)."""
    from direct_data_driven_mpc_jax.viz.plots import (
        plot_input_output_animation,
    )

    rng = np.random.default_rng(0)
    T, initial = 200, 150  # wide region: labels must fit eventually
    u = rng.normal(size=(T, 2))
    y = rng.normal(size=(T, 2))
    anim = plot_input_output_animation(
        u, y, np.array([[1.0], [1.0]]), np.array([[0.65], [0.77]]),
        initial_steps=initial, points_per_frame=10,
    )
    fig = anim._fig
    fig.canvas.draw()

    texts_of = lambda: [
        t
        for ax in fig.get_axes()
        for t in ax.texts
        if "Init." in t.get_text()
    ]
    assert len(texts_of()) == 4  # one per channel (2 inputs, 2 outputs)

    anim._func(0)  # frame 0: nothing revealed yet
    assert all(not t.get_visible() for t in texts_of())

    anim._func(initial // 10)  # region fully grown
    vis = [t.get_visible() for t in texts_of()]
    assert all(vis), f"labels still hidden after full reveal: {vis}"
    # Labels are centered in the grown region.
    assert all(
        abs(t.get_position()[0] - initial / 2) < 1e-9 for t in texts_of()
    )

    import matplotlib.pyplot as plt

    plt.close("all")


def test_static_plot_applies_padded_limits():
    """The static path must apply get_padded_limits (reference
    :292-322), covering data AND setpoints with proportional pad."""
    from direct_data_driven_mpc_jax.viz.plots import (
        get_padded_limits,
        plot_input_output,
    )

    rng = np.random.default_rng(0)
    u = rng.normal(size=(30, 1))
    y = rng.normal(size=(30, 1)) * 0.1
    y_s = np.array([[5.0]])  # setpoint far outside the data range
    fig = plot_input_output(
        u, y, np.array([[1.0]]), y_s, show=False
    )
    ax_y = fig.get_axes()[-1]
    expected = get_padded_limits(y[:, 0], np.array([5.0]))
    got = ax_y.get_ylim()
    np.testing.assert_allclose(got, expected, rtol=1e-9)
    assert got[1] > 5.0  # setpoint inside the limits

    import matplotlib.pyplot as plt

    plt.close("all")


def test_save_animation_gif_fallback(tmp_path):
    """Animation export works without ffmpeg (Pillow gif fallback)."""
    from direct_data_driven_mpc_jax.viz.plots import (
        plot_input_output_animation,
        save_animation,
    )

    rng = np.random.default_rng(0)
    u = rng.normal(size=(20, 2))
    y = rng.normal(size=(20, 2))
    anim = plot_input_output_animation(
        u, y, np.array([[1.0], [1.0]]), np.array([[0.65], [0.77]]),
        points_per_frame=10,
    )
    path = tmp_path / "anim.gif"
    save_animation(anim, total_frames=3, fps=5, bitrate=100,
                   file_path=str(path))
    assert path.stat().st_size > 0

    import matplotlib.pyplot as plt

    plt.close("all")


def test_setpoint_tracking_example_cli(monkeypatch, capsys, tmp_path):
    """The tracking example drives the condensed tracking engine end to
    end (staircase schedule, batch of scenarios, percentile figure)."""
    import setpoint_tracking_example as ex

    fig = tmp_path / "tracking.png"
    out = _run_main(
        ex,
        [
            "prog",
            "--batch",
            "16",
            "--t_sim",
            "60",
            "--phases",
            "3",
            "--solves_per_block",
            "10",
            "--seed",
            "0",
            "--save_fig",
            str(fig),
        ],
        monkeypatch,
        capsys,
    )
    assert "Simulation finished" in out.out
    assert "RMS tracking error" in out.out
    assert fig.exists() and fig.stat().st_size > 0
