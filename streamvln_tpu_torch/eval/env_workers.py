"""Multi-process environment workers for batched evaluation (PyTorch
port).

A twin of `streamvln_tpu/eval/env_workers.py`. One process owns the card
and drives N env slots (eval/batched_evaluator.py), so the simulators
come to the model: each env lives in its own spawned process behind a pipe
command protocol with asynchronous step dispatch, so N simulator steps run
concurrently on the host.

Works with any picklable env_factory returning the FakeNavEnv interface
(reset/step/episode_over/get_metrics/current_episode/close).
"""
from __future__ import annotations

import multiprocessing as mp
from typing import Callable

import numpy as np


def _worker_loop(env_factory, conn, obs_transform=None):
    env = env_factory()
    tf = obs_transform or (lambda obs: obs)
    try:
        while True:
            cmd, arg = conn.recv()
            if cmd == "reset":
                conn.send(tf(env.reset()))
            elif cmd == "step":
                conn.send(tf(env.step(arg)))
            elif cmd == "episode_over":
                conn.send(env.episode_over)
            elif cmd == "get_metrics":
                conn.send(env.get_metrics())
            elif cmd == "set_episode":
                env.current_episode = arg
                conn.send(True)
            elif cmd == "getattr":
                conn.send(getattr(env, arg))
            elif cmd == "close":
                if hasattr(env, "close"):
                    env.close()
                conn.send(True)
                break
    except (EOFError, KeyboardInterrupt):
        pass


class RemoteEnv:
    """Parent-side proxy for one env worker process.

    Mirrors the in-process env interface; additionally exposes
    step_async/step_wait so the evaluator can overlap N sim steps.
    """

    def __init__(self, env_factory: Callable[[], object],
                 ctx=None, obs_transform=None):
        # spawn, not fork: the evaluator process holds a CUDA context
        # (threads and locks that are not fork-safe); spawned workers
        # start clean. env_factory (and obs_transform) must be picklable.
        # obs_transform runs INSIDE the worker on every observation, e.g. a
        # host-side frame resize, so raw 640x480 frames never cross the
        # pipe (the reference resizes host-side too).
        ctx = ctx or mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_worker_loop,
                                 args=(env_factory, child,
                                       obs_transform),
                                 daemon=True)
        self._proc.start()
        child.close()
        self._pending = False

    def _call(self, cmd, arg=None):
        assert not self._pending, "collect step_wait() first"
        self._conn.send((cmd, arg))
        return self._conn.recv()

    def reset(self):
        return self._call("reset")

    def step(self, action):
        return self._call("step", action)

    def step_async(self, action):
        assert not self._pending
        self._conn.send(("step", action))
        self._pending = True

    def step_wait(self):
        assert self._pending
        self._pending = False
        return self._conn.recv()

    @property
    def episode_over(self):
        return self._call("episode_over")

    def get_metrics(self):
        return self._call("get_metrics")

    @property
    def current_episode(self):
        return self._call("getattr", "current_episode")

    @current_episode.setter
    def current_episode(self, ep):
        self._call("set_episode", ep)

    def close(self):
        # an evaluator error between step_async and step_wait leaves a
        # reply in flight; drain it so close() doesn't trip the
        # no-pending assert and mask the original exception
        if self._pending:
            try:
                self.step_wait()
            except (BrokenPipeError, EOFError):
                self._pending = False
        try:
            self._call("close")
        except (BrokenPipeError, EOFError):
            pass
        self._proc.join(timeout=5)
        if self._proc.is_alive():
            self._proc.terminate()


def remote_env_factory(
        env_factory: Callable[[], object],
        obs_transform=None) -> Callable[[], RemoteEnv]:
    """Wrap a (picklable) env factory so each call spawns a worker
    process: `BatchedVLNEvaluator(remote_env_factory(make_env), ...)`
    hosts every slot's simulator out-of-process. obs_transform (also
    picklable) post-processes observations worker-side."""
    ctx = mp.get_context("spawn")
    return lambda: RemoteEnv(env_factory, ctx, obs_transform)


def resize_rgb_transform(size: int):
    """Picklable worker-side obs transform: a PIL-exact bicubic resize of
    obs['rgb'] to [size, size, 3] through the native library
    (native/dataloader.cpp), or PIL where the library does not build, so
    pipes and the host->device link carry compact frames."""
    return _ResizeRGB(size)


class _ResizeRGB:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, obs):
        if isinstance(obs, dict) and "rgb" in obs:
            rgb = obs["rgb"]
            if rgb.shape[0] != self.size or rgb.shape[1] != self.size:
                from streamvln_tpu_torch import native
                obs = dict(obs)
                if native.available():
                    obs["rgb"] = native.resize_batch_u8(rgb[None],
                                                        self.size)[0]
                else:
                    from PIL import Image
                    obs["rgb"] = np.asarray(Image.fromarray(rgb).resize(
                        (self.size, self.size), Image.BICUBIC), np.uint8)
        return obs
