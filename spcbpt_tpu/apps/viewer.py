"""Interactive progressive terminal viewer — the reference's inspect loop.

Parity target (reference: optixPathTracer.cpp:121-240 GLFW callbacks,
sutil.cpp:715-752 stats overlay, operation.md:5):
  Space      cycle algorithm pt -> bdpt -> spcbpt   (Space toggle)
  w / s      fly forward / back along the view ray  (W key)
  a / d      strafe left / right
  arrows     orbit eye around lookat                (mouse trackball)
  + / -      zoom (fov)
  c          print camera pose                      (C key)
  p          pause/resume progressive accumulation  (P one-frame mode)
  r          reset accumulation
  q / ESC    quit

The frame is drawn with 24-bit ANSI half-blocks (two pixels per character
cell), so it runs over ssh with no window system — the headless stand-in
for the reference's GLFW/ImGui window. Progressive accumulation resets on
any camera or algorithm change (reference updateState:371-380).

Headless/scripted mode: --keys "<string>" feeds one key per rendered frame
(used by tests and for driving without a tty).
"""
from __future__ import annotations

import argparse
import os
import select
import sys
import time

import numpy as np


ALGS = ("pt", "bdpt", "spcbpt")
ESC = "\x1b"


def build_argparser():
    p = argparse.ArgumentParser(description="spcbpt_tpu interactive viewer")
    p.add_argument("--scene", default="cornell")
    p.add_argument("--alg", default="pt", choices=list(ALGS))
    p.add_argument("--dim", default="256x256", help="render WxH")
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--light-paths", type=int, default=None,
                   help="light sub-paths per frame (default: pixels/2)")
    p.add_argument("--resume", default=None,
                   help="trained-state npz for spcbpt mode")
    p.add_argument("--keys", default=None,
                   help="scripted key string, one key per frame (headless)")
    p.add_argument("--frames", type=int, default=0,
                   help="stop after N frames (0 = run until quit)")
    p.add_argument("--out", default=None, help="save final frame as PNG")
    p.add_argument("--no-display", action="store_true",
                   help="skip ANSI frame output (stats lines only)")
    return p


# --------------------------------------------------------------------------
# terminal plumbing
# --------------------------------------------------------------------------

class KeySource:
    """Nonblocking keys from a tty, or a scripted string (one per poll)."""

    def __init__(self, scripted: str | None):
        self.scripted = list(scripted) if scripted is not None else None
        self._raw = False
        self.interactive = self.scripted is None and sys.stdin.isatty()
        if self.interactive:
            import termios
            import tty
            self._fd = sys.stdin.fileno()
            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
            self._raw = True

    def poll(self) -> str | None:
        if self.scripted is not None:
            return self.scripted.pop(0) if self.scripted else None
        if not self._raw:
            return None
        r, _, _ = select.select([sys.stdin], [], [], 0)
        if not r:
            return None
        ch = sys.stdin.read(1)
        if ch == ESC:                      # arrow keys: ESC [ A/B/C/D
            r, _, _ = select.select([sys.stdin], [], [], 0.01)
            if r:
                seq = sys.stdin.read(2)
                return {"[A": "UP", "[B": "DOWN",
                        "[C": "RIGHT", "[D": "LEFT"}.get(seq, ESC)
        return ch

    def close(self):
        if self._raw:
            import termios
            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)


def ansi_frame(rgb8: np.ndarray, max_cols: int, max_rows: int) -> str:
    """(H, W, 3) uint8 -> truecolor half-block string (2 px per text row)."""
    h, w, _ = rgb8.shape
    # integer box-downsample to fit the terminal
    fx = max(1, -(-w // max_cols))
    fy = max(1, -(-(h // 2) // max_rows) * 2)
    hh, ww = h // fy * fy, w // fx * fx
    img = rgb8[:hh, :ww].reshape(hh // fy, fy, ww // fx, fx, 3)
    img = img.astype(np.uint16).mean(axis=(1, 3)).astype(np.uint8)
    top = img[0::2]
    bot = img[1::2][:top.shape[0]]
    rows = []
    for tr, br in zip(top, bot):
        cells = [f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                 f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
                 for t, b in zip(tr, br)]
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


# --------------------------------------------------------------------------
# camera motion (reference: Trackball orbit + W fly, optixPathTracer.cpp)
# --------------------------------------------------------------------------

def orbit(cam, yaw_deg: float, pitch_deg: float):
    """Rotate eye around lookat: yaw about `up`, pitch about the right axis."""
    eye = np.asarray(cam.eye, np.float64)
    look = np.asarray(cam.lookat, np.float64)
    up = np.asarray(cam.up, np.float64)
    up = up / np.linalg.norm(up)
    v = eye - look

    def rot(axis, deg):
        axis = axis / np.linalg.norm(axis)
        th = np.deg2rad(deg)
        c, s = np.cos(th), np.sin(th)
        return (c * np.eye(3) + s * np.array([[0, -axis[2], axis[1]],
                                              [axis[2], 0, -axis[0]],
                                              [-axis[1], axis[0], 0]])
                + (1 - c) * np.outer(axis, axis))

    if yaw_deg:
        v = rot(up, yaw_deg) @ v
    if pitch_deg:
        right = np.cross(v / np.linalg.norm(v), up)
        if np.linalg.norm(right) > 1e-6:
            v = rot(right, pitch_deg) @ v
    cam.eye = (look + v).astype(np.float32)


def fly(cam, frac: float):
    """Move eye along the view direction by `frac` of the eye-lookat
    distance (reference W key flies forward)."""
    eye = np.asarray(cam.eye, np.float64)
    look = np.asarray(cam.lookat, np.float64)
    step = (look - eye) * frac
    cam.eye = (eye + step).astype(np.float32)
    cam.lookat = (look + step).astype(np.float32)


def strafe(cam, frac: float):
    eye = np.asarray(cam.eye, np.float64)
    look = np.asarray(cam.lookat, np.float64)
    up = np.asarray(cam.up, np.float64)
    w = look - eye
    right = np.cross(w, up)
    right = right / max(np.linalg.norm(right), 1e-30)
    step = right * frac * np.linalg.norm(w)
    cam.eye = (eye + step).astype(np.float32)
    cam.lookat = (look + step).astype(np.float32)


# --------------------------------------------------------------------------
# main loop
# --------------------------------------------------------------------------

def main(argv=None):
    args = build_argparser().parse_args(argv)

    import jax
    import jax.numpy as jnp
    from ..runtime import setup as _setup
    _setup()
    from ..render import light_trace, lvc, pt_pool, spcbpt_pool
    from ..render.film import Film
    from ..scene.scene import load_trace_scene
    from ..train import classify
    from .render_cli import resolve_scene
    from .. import checkpoint as ckpt_mod

    width, height = map(int, args.dim.lower().split("x"))
    ts, desc, cam = load_trace_scene(resolve_scene(args.scene))
    cam.aspect = width / height
    n_lp = args.light_paths or max(width * height // 2, 4096)

    ss = classify.untrained_state()
    if args.resume:
        ss = ckpt_mod.load_subspace_state(args.resume)

    lt_jit = jax.jit(lambda ts_, ss_, f: light_trace.trace_light_paths(
        ts_, ss_, n_lp, f, max_depth=8))
    lt_fn = lambda f: lt_jit(ts, ss, f)
    build = lvc.make_builder(ss)

    def render_one(alg: str, uvw, subframe: int):
        eye, U, V, W = uvw
        if alg == "pt":
            fsum, count = pt_pool.render_pool_jit(
                ts, eye, U, V, W, width, height, 1, subframe,
                max_depth=args.max_depth)
        else:
            sampler = build(lt_fn(subframe + 7919), subframe)
            fsum, count = spcbpt_pool.render_pool_jit(
                ts, ss, sampler, eye, U, V, W, width, height, 1, subframe,
                max_depth=args.max_depth, uniform=(alg == "bdpt"))
        return fsum / jnp.maximum(count[:, None], 1)

    alg_i = ALGS.index(args.alg)
    film = Film(width, height)
    keys = KeySource(args.keys)
    paused = False
    frames = 0
    tty_out = sys.stdout.isatty() and not args.no_display
    try:
        if tty_out:
            sys.stdout.write("\x1b[2J")     # clear once
        while True:
            t0 = time.time()
            if not paused or film.subframe == 0:
                film.add(render_one(ALGS[alg_i], cam.uvw(), film.subframe))
                np.asarray(film.accum)      # fence for honest timing
            dt = time.time() - t0
            frames += 1

            if tty_out:
                cols, rows = os.get_terminal_size()
                sys.stdout.write("\x1b[H")
                sys.stdout.write(ansi_frame(film.display(), cols, rows - 2))
                sys.stdout.write("\n")
            if tty_out or not args.no_display:
                sys.stdout.write(
                    f"[{ALGS[alg_i]}] {width}x{height} "
                    f"spp {film.subframe:4d} | {dt*1e3:7.1f} ms/frame "
                    f"({1.0/max(dt,1e-9):5.1f} fps) | Space=alg "
                    f"arrows=orbit w/s=fly p=pause q=quit\x1b[K\n")
                sys.stdout.flush()

            if args.frames and frames >= args.frames:
                break
            k = keys.poll()
            if k is None:
                if not keys.interactive and not args.frames:
                    break   # no tty, no scripted keys left: no quit path
                continue
            if k in ("q", ESC):
                break
            reset = True
            if k == " ":
                alg_i = (alg_i + 1) % len(ALGS)
            elif k in ("LEFT", "h"):
                orbit(cam, +10.0, 0.0)
            elif k in ("RIGHT", "l"):
                orbit(cam, -10.0, 0.0)
            elif k in ("UP", "k"):
                orbit(cam, 0.0, +10.0)
            elif k in ("DOWN", "j"):
                orbit(cam, 0.0, -10.0)
            elif k == "w":
                fly(cam, +0.1)
            elif k == "s":
                fly(cam, -0.1)
            elif k == "a":
                strafe(cam, -0.1)
            elif k == "d":
                strafe(cam, +0.1)
            elif k == "+":
                cam.fov_y = max(5.0, cam.fov_y * 0.9)
            elif k == "-":
                cam.fov_y = min(150.0, cam.fov_y / 0.9)
            elif k == "r":
                pass                        # plain reset
            elif k == "p":
                paused = not paused
                reset = False
            elif k == "c":
                print(f"\n[camera] eye {np.asarray(cam.eye)} "
                      f"lookat {np.asarray(cam.lookat)} fov {cam.fov_y}")
                reset = False
            else:
                reset = False
            if reset:
                film.reset()
    finally:
        keys.close()

    if args.out:
        film.save_png(args.out)
        print(f"[out] {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
