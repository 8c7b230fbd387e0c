"""The port's robot-side serving against the JAX package's on the CPU: the
goal integrator and PD controller copies bit for bit, the HTTP agent
server (`AgentService` behind /eval_vln) request for request over 36
frames posted by the client, and the Go2 client's plan/control loop.

The agents run tiny_streamvln in float32 on the JAX init's weights with a
steered lm_head (`test_torch_eval.steer`), so calls emit arrows and the
service walks through its window resets and <memory> calls instead of
stopping at its first request.
"""
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from streamvln_tpu.configs import tiny_streamvln as jax_tiny
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.realworld import go2_vln_client as jclient
from streamvln_tpu.realworld import goal_integrator as jgoal
from streamvln_tpu.realworld import pid_controller as jpid
from streamvln_tpu.serve import http_server as jhttp
from streamvln_tpu_torch.configs import tiny_streamvln
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.realworld import go2_vln_client as tclient
from streamvln_tpu_torch.realworld import goal_integrator as tgoal
from streamvln_tpu_torch.realworld import pid_controller as tpid
from streamvln_tpu_torch.serve import http_server as thttp
from streamvln_tpu_torch.weights import from_jax_params
from test_torch_eval import _agents, steer

TIMEOUT = 120


def _pose(rng):
    pose = np.eye(4)
    yaw = rng.uniform(-np.pi, np.pi)
    pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    pose[:2, 3] = rng.uniform(-3, 3, 2)
    return pose


def test_goal_integrator_and_pid_are_the_reference_copies():
    rng = np.random.default_rng(0)
    for _ in range(50):
        start = _pose(rng)
        actions = [int(a) for a in rng.integers(0, 4, 12)]
        got = tgoal.incremental_change_goal(start.copy(), actions)
        np.testing.assert_array_equal(
            got, jgoal.incremental_change_goal(start.copy(), actions))
        odom, vel = _pose(rng), tuple(rng.uniform(-1, 1, 2))
        gains = dict(zip(("kp_trans", "kd_trans", "kp_yaw", "kd_yaw",
                          "max_v", "max_w"), rng.uniform(0.1, 2.0, 6)))
        assert tpid.PIDController(**gains).solve(odom, got, vel) == \
            jpid.PIDController(**gains).solve(odom, got, vel)
    with pytest.raises(ValueError):
        tgoal.incremental_change_goal(np.eye(4), [4])


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The JAX and the port HTTP agent servers on steered tiny weights."""
    jp = jax.tree.map(np.asarray, jsv.init(jax.random.PRNGKey(0),
                                           jax_tiny()))
    jp = steer(jp, ByteTokenizer(), alpha=30.0)
    tp = from_jax_params(jp, tiny_streamvln(), device="cpu")
    ja, ta = _agents((jp, tp))
    root = tmp_path_factory.mktemp("runs")
    out = {}
    for name, agent, mod in (("jax", ja, jhttp), ("port", ta, thttp)):
        service = mod.AgentService(agent, "walk ahead",
                                   num_future_steps=agent.cfg.num_future_steps,
                                   run_root=str(root / name))
        server = mod.serve(service, host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        out[name] = (f"http://127.0.0.1:{server.server_address[1]}",
                     service, server, thread)
    yield out
    for _, _, server, thread in out.values():
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def test_agent_service_matches_jax_over_36_frames(servers):
    """36 frames posted by the port's client as the robot posts them (JPEG:
    both servers decode the same bytes), the first with reset and the
    instruction: every request's action list equal to the JAX server's,
    none a STOP (which would end the run: the service answers [0] from
    then on), with a model call each (num_future_steps agent steps per
    request), across the window resets and <memory> calls at every
    num_frames steps. The JAX client's JPEG posts are held by the
    plan/control test below."""
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (36, 48, 64, 3), np.uint8)
    got = {}
    for name in ("jax", "port"):
        url, service = servers[name][:2]
        eng = service.agent.engine
        calls0 = eng.decode_forwards
        got[name] = [tclient.post_frame(url, f, reset=i == 0,
                                        instruction="walk to the door"
                                        if i == 0 else None,
                                        timeout=TIMEOUT)
                     for i, f in enumerate(frames)]
        got[name + "_steps"] = service.agent.step_id[0]
        got[name + "_forwards"] = eng.decode_forwards - calls0
    assert got["port"] == got["jax"]
    assert all(a and 0 not in a for a in got["port"])
    nfs = tiny_streamvln().num_future_steps
    assert got["port_steps"] == got["jax_steps"] == 36 * nfs
    assert got["port_forwards"] == got["jax_forwards"] > 0
    assert servers["port"][1].instruction == "walk to the door"


def test_multipart_and_garbage(servers):
    """A multipart/form-data frame gets the same reply from both servers;
    a body that is not JSON gets 400, an unknown path 404."""
    from PIL import Image
    import io
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (48, 64, 3), np.uint8)).save(buf, format="PNG")
    boundary = "xXxBOUNDARYxXx"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\""
            f"; filename=\"f.png\"\r\nContent-Type: image/png\r\n\r\n"
            ).encode() + buf.getvalue() + (
        f"\r\n--{boundary}\r\nContent-Disposition: form-data; name=\"json\""
        f"\r\n\r\n{json.dumps({'reset': True})}\r\n--{boundary}--\r\n"
    ).encode()
    replies = []
    for name in ("jax", "port"):
        url = servers[name][0]
        req = urllib.request.Request(
            url + "/eval_vln", data=body, headers={
                "Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            replies.append(json.loads(r.read()))
    assert replies[1] == replies[0] and replies[1]["action"]
    url = servers["port"][0]
    for path, data, code in (("/eval_vln", b"not json", 400),
                             ("/elsewhere", b"{}", 404)):
        req = urllib.request.Request(
            url + path, data=data,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert e.value.code == code


def test_go2_manager_plan_and_control_match_jax(servers):
    """Each package's Go2VlnManager (no ROS) against its own server: the
    same actions, goal poses and PD commands over three planning rounds;
    the ROS wiring refuses without rclpy."""
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (3, 48, 64, 3), np.uint8)
    out = {}
    for name, client in (("jax", jclient), ("port", tclient)):
        mgr = client.Go2VlnManager(server_url=servers[name][0],
                                   instruction="move forward", use_ros=False)
        assert mgr.plan_once() is None            # no image yet
        mgr.set_odom(0.5, -0.25, 0.3, v=0.1, w=0.05)
        rec = []
        for img in images:
            mgr.set_image(img)
            rec.append((mgr.plan_once(), mgr.homo_goal.copy(),
                        mgr.control_once()))
        out[name] = rec
    for (ta, tg, tc), (ja, jg, jc) in zip(out["port"], out["jax"]):
        assert ta == ja and ta
        np.testing.assert_array_equal(tg, jg)
        assert tc == jc and np.isfinite(tc).all()
    assert not np.array_equal(out["port"][-1][1], np.eye(4))
    with pytest.raises(ImportError):
        tclient.Go2VlnManager(use_ros=True)
