"""The port's autoscaler against the JAX package's, on the CPU.

The demand scheduler and the instance manager's state machine get
``test_autoscaler.py``'s and ``test_autoscaler_im.py``'s scenarios on both
packages, and each test compares the two plans or state traces (and holds
them to the reference tests' expectations). One ``AutoscalingCluster`` a
package scales up on demand and down when idle: the JAX package's on a
custom resource, the port's on a GPU host whose node type declares
``GPU: 1`` (no probing), where the actor that asked for the card is
pinned to it; both run at once in two threads. The port's GPU-VM
provider, its launcher (``up``/``down``, also through the CLI) and the
GCE preemption source run against a recorded ``gcloud`` and a local HTTP
server: nothing here reaches a cloud.

Remote functions and actors are defined inside the scenarios, so no
worker imports this module (which imports JAX).
"""

import ast
import http.server
import importlib
import json
import os
import re
import shutil
import socket
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.autoscaler.{name}")


def _both(scenario):
    """``scenario(pkg)`` on both packages: (jax, port)."""
    return scenario("ray_tpu"), scenario("ray_tpu_torch")


# ------------------------------------------------------------- scheduler

SCHEDULER_CASES = {
    # name: (node types, demands, node_avail, current_counts, reference plan)
    "packs_existing_capacity": (
        {"m1": {"resources": {"CPU": 4}, "min_workers": 0,
                "max_workers": 5}},
        [{"CPU": 1}] * 3, [{"CPU": 4}], {}, {}),
    "launches_for_overflow": (
        {"m1": {"resources": {"CPU": 4}, "min_workers": 0,
                "max_workers": 5}},
        [{"CPU": 1}] * 10, [{"CPU": 2}], {"m1": 1}, {"m1": 2}),
    "respects_max_workers": (
        {"m1": {"resources": {"CPU": 1}, "min_workers": 0,
                "max_workers": 2}},
        [{"CPU": 1}] * 10, [], {"m1": 1}, {"m1": 1}),
    "min_workers_without_demand": (
        {"m1": {"resources": {"CPU": 1}, "min_workers": 3,
                "max_workers": 5}},
        [], [], {"m1": 1}, {"m1": 2}),
    "picks_cheapest_feasible_type": (
        {"big": {"resources": {"CPU": 16}, "min_workers": 0,
                 "max_workers": 5},
         "small": {"resources": {"CPU": 2}, "min_workers": 0,
                   "max_workers": 5}},
        [{"CPU": 1}], [], {}, {"small": 1}),
    "infeasible_demand_ignored": (
        {"m1": {"resources": {"CPU": 2}, "min_workers": 0,
                "max_workers": 5}},
        [{"CPU": 64}], [], {}, {}),
    # the port's node types carry cards: two half-card actors fit one
    # one-card host, a third needs a second host
    "half_cards_share_a_host": (
        {"h100": {"resources": {"CPU": 4, "GPU": 1}, "min_workers": 0,
                  "max_workers": 4}},
        [{"CPU": 1, "GPU": 0.5}] * 3, [], {}, {"h100": 2}),
}


@pytest.mark.parametrize("case", sorted(SCHEDULER_CASES))
def test_scheduler_plans_match_the_reference(case):
    types, demands, avail, counts, want = SCHEDULER_CASES[case]

    def plan(pkg):
        s = _mod(pkg, "scheduler").ResourceDemandScheduler(types)
        return s.get_nodes_to_launch(demands=demands, node_avail=avail,
                                     current_counts=counts)

    jax_plan, port_plan = _both(plan)
    assert port_plan == jax_plan == want


# ------------------------------------------------------ instance manager


def _fake_cloud(pkg, fail_creates=0):
    """``test_autoscaler_im.py``'s in-memory provider, on ``pkg``'s
    ``NodeProvider``; ``preempt()`` takes an instance back as a cloud
    takes back a spot VM."""
    np_mod = _mod(pkg, "node_provider")

    class FakeCloud(np_mod.NodeProvider):
        def __init__(self):
            self.nodes = {}
            self.counter = 0
            self.fail_creates = fail_creates

        def create_node(self, node_type, resources):
            if self.fail_creates > 0:
                self.fail_creates -= 1
                raise RuntimeError("quota exceeded")
            self.counter += 1
            inst = np_mod.NodeInstance(
                f"cloud-{self.counter}", node_type,
                f"node{self.counter:02d}" * 4, dict(resources))
            self.nodes[inst.instance_id] = inst
            return inst

        def terminate_node(self, instance_id):
            self.nodes.pop(instance_id, None)

        def non_terminated_nodes(self):
            return list(self.nodes.values())

        def preempt(self, instance_id):
            self.nodes.pop(instance_id, None)

    return FakeCloud()


def _events(events):
    return sorted((e["event"], e.get("phase", "")) for e in events)


def _im_lifecycle(pkg):
    im_mod = _mod(pkg, "instance_manager")
    cloud = _fake_cloud(pkg)
    im = im_mod.InstanceManager(cloud)
    (inst,) = im.launch("h100", {"GPU": 1}, 1)
    trace = [inst.state]
    trace.append(_events(im.reconcile(alive_node_ids=[])))
    trace += [inst.state, inst.cloud_instance_id in cloud.nodes]
    trace.append(_events(im.reconcile(alive_node_ids=[inst.node_id_hex])))
    trace += [inst.state, im.live_counts()]
    return trace


def _im_allocation_failure(pkg):
    im_mod = _mod(pkg, "instance_manager")
    im = im_mod.InstanceManager(_fake_cloud(pkg, fail_creates=1))
    (inst,) = im.launch("h100", {"GPU": 1}, 1)
    return [_events(im.reconcile([])), inst.state, im.live_counts()]


def _im_preemption_in_both_phases(pkg):
    im_mod = _mod(pkg, "instance_manager")
    cloud = _fake_cloud(pkg)
    im = im_mod.InstanceManager(cloud)
    a, b = im.launch("h100", {"GPU": 1}, 2)
    im.reconcile([])
    im.reconcile([a.node_id_hex])
    trace = [a.state, b.state]
    cloud.preempt(a.cloud_instance_id)
    cloud.preempt(b.cloud_instance_id)
    trace.append(_events(im.reconcile([a.node_id_hex])))
    trace += [a.state, a.preempted, b.state, b.preempted, im.live_counts()]
    return trace


def _fake_gcs_autoscaler(pkg, cloud, idle_timeout_s=60.0, min_workers=1,
                         drain=False):
    """An Autoscaler whose GCS view is the fake cloud's instances (every
    allocated one an alive node); with ``drain`` its drain requests are
    recorded and ``busy_nodes`` marks nodes with running work."""
    auto = _mod(pkg, "autoscaler")
    im_mod = _mod(pkg, "instance_manager")
    states = (im_mod.ALLOCATED, im_mod.RAY_RUNNING, im_mod.RAY_DRAINING)

    class FakeGcsAutoscaler(auto.Autoscaler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.drain_requests = []
            self.busy_nodes = set()

        def _state(self):
            nodes = []
            for inst in self.im.instances.values():
                if inst.state in states and \
                        inst.cloud_instance_id in self.provider.nodes:
                    nodes.append({
                        "node_id": inst.node_id_hex, "alive": True,
                        "avail": dict(inst.resources),
                        "idle_s": 1e9 if drain else 0.0,
                        "busy": inst.node_id_hex in self.busy_nodes,
                        "draining": inst.state == im_mod.RAY_DRAINING})
            return {"nodes": nodes, "demands": []}

        def _request_drain(self, node_id_hex, reason):
            self.drain_requests.append(node_id_hex)
            return True

    cfg = auto.AutoscalerConfig(
        node_types={"h100": auto.NodeTypeConfig(
            resources={"CPU": 4.0, "GPU": 1.0}, min_workers=min_workers,
            max_workers=3)},
        idle_timeout_s=idle_timeout_s)
    return FakeGcsAutoscaler(cfg, cloud, gcs_address="fake")


def _reconciler_replaces_preempted_host(pkg):
    cloud = _fake_cloud(pkg)
    a = _fake_gcs_autoscaler(pkg, cloud)
    a.update()
    (first,) = list(a.im.instances.values())
    trace = [first.state]
    a.update()
    trace.append(first.state)
    cloud.preempt(first.cloud_instance_id)
    summary = a.update()
    live = [i for i in a.im.instances.values()
            if i.state in ("ALLOCATED", "RAY_RUNNING")]
    trace += [first.state, first.preempted, a.preempted_total,
              _events(summary["events"]), len(live),
              live[0].im_id != first.im_id, a.im.live_counts()]
    a.update()
    trace.append(live[0].state)
    return trace


def _idle_termination_through_drain(pkg):
    cloud = _fake_cloud(pkg)
    a = _fake_gcs_autoscaler(pkg, cloud, idle_timeout_s=0.0, min_workers=0,
                             drain=True)
    (inst,) = a.im.launch("h100", {"GPU": 1.0}, 1)
    a.im.reconcile([])
    a.im.reconcile([inst.node_id_hex])
    a.busy_nodes.add(inst.node_id_hex)
    trace = []
    for busy in (True, True, False, False):
        if not busy:
            a.busy_nodes.discard(inst.node_id_hex)
        summary = a.update()
        trace.append((len(a.drain_requests), inst.state,
                      inst.cloud_instance_id in cloud.nodes,
                      summary["drained"], summary["terminated"]))
    return trace


def _draining_host_released_when_forced_dead(pkg):
    cloud = _fake_cloud(pkg)
    a = _fake_gcs_autoscaler(pkg, cloud, idle_timeout_s=0.0, min_workers=0,
                             drain=True)
    (inst,) = a.im.launch("h100", {"GPU": 1.0}, 1)
    a.im.reconcile([])
    a.im.reconcile([inst.node_id_hex])
    a.busy_nodes.add(inst.node_id_hex)
    a.update()
    trace = [inst.state]
    cloud_id = inst.cloud_instance_id
    a._state = lambda: {"nodes": [], "demands": []}
    a.update()
    return trace + [inst.state, cloud_id in cloud.nodes]


def _drain_respects_min_workers_across_rounds(pkg):
    cloud = _fake_cloud(pkg)
    a = _fake_gcs_autoscaler(pkg, cloud, idle_timeout_s=0.0, min_workers=1,
                             drain=True)
    insts = a.im.launch("h100", {"GPU": 1.0}, 2)
    a.im.reconcile([])
    a.im.reconcile([i.node_id_hex for i in insts])
    for i in insts:
        a.busy_nodes.add(i.node_id_hex)
    trace = []
    for _ in range(4):
        a.update()
        trace.append((len(a.drain_requests),
                      sorted(i.state for i in insts)))
    return trace


IM_CASES = {
    "lifecycle": (_im_lifecycle, [
        "QUEUED", [("allocated", "")], "ALLOCATED", True,
        [("ray_running", "")], "RAY_RUNNING", {"h100": 1}]),
    "allocation_failure": (_im_allocation_failure, [
        [("allocation_failed", "")], "ALLOCATION_FAILED", {}]),
    "preemption_in_both_phases": (_im_preemption_in_both_phases, [
        "RAY_RUNNING", "ALLOCATED",
        [("preempted", "allocated"), ("preempted", "running")],
        "TERMINATED", True, "TERMINATED", True, {}]),
    "reconciler_replaces_preempted_host": (
        _reconciler_replaces_preempted_host, [
            "ALLOCATED", "RAY_RUNNING", "TERMINATED", True, 1,
            [("allocated", ""), ("preempted", "running")], 1, True,
            {"h100": 1}, "RAY_RUNNING"]),
    "idle_termination_through_drain": (_idle_termination_through_drain, [
        (1, "RAY_DRAINING", True, ["h100"], []),
        (1, "RAY_DRAINING", True, [], []),
        (1, "RAY_DRAINING", True, [], []),
        (1, "TERMINATING", False, [], ["h100"])]),
    "draining_host_released_when_forced_dead": (
        _draining_host_released_when_forced_dead, [
            "RAY_DRAINING", "TERMINATING", False]),
    "drain_respects_min_workers_across_rounds": (
        _drain_respects_min_workers_across_rounds,
        [(1, ["RAY_DRAINING", "RAY_RUNNING"])] * 4),
}


@pytest.mark.parametrize("case", sorted(IM_CASES))
def test_instance_manager_traces_match_the_reference(case):
    scenario, want = IM_CASES[case]
    jax_trace, port_trace = _both(scenario)
    assert port_trace == jax_trace
    assert port_trace == want


# ------------------------------------------------------------ end to end


def _short_root():
    """A short directory for sessions: UNIX socket paths in it must stay
    under the kernel's 108-byte limit."""
    base = tempfile.gettempdir()
    return tempfile.mkdtemp(prefix="rta", dir=base if len(base) < 48
                            else "/tmp")


def _scale_scenario(pkg):
    """Scale up on demand, down when idle, and ``request_resources``'s
    standing demand, on one ``AutoscalingCluster``."""
    rt = importlib.import_module(pkg)
    testing = _mod(pkg, "testing")
    port = pkg == "ray_tpu_torch"
    if port:
        # the port's node type: a host with one card (declared, not
        # probed) and its type label
        cluster = testing.AutoscalingCluster(
            head_resources={"CPU": 1},
            worker_node_types={"h100": {"resources": {"CPU": 2, "GPU": 1},
                                        "min_workers": 0,
                                        "max_workers": 1}},
            idle_timeout_s=3.0, update_interval_s=0.25,
            gpu=True, accelerator_type="H100", gpus_per_host=1)
        scaled_key = "GPU"
    else:
        cluster = testing.AutoscalingCluster(
            head_resources={"CPU": 1},
            worker_node_types={"cpu_worker": {
                "resources": {"CPU": 2, "scale_res": 2},
                "min_workers": 0, "max_workers": 1}},
            idle_timeout_s=3.0, update_interval_s=0.25)
        scaled_key = "scale_res"
    out = {}
    try:
        cluster.start()
        cluster.connect()
        out["before"] = scaled_key in rt.cluster_resources()
        if port:
            @rt.remote(num_cpus=1, num_gpus=1)
            class Pinned:
                def ids(self):
                    import os

                    import ray_tpu_torch

                    return (ray_tpu_torch.get_gpu_ids(),
                            os.environ.get("CUDA_VISIBLE_DEVICES"))
        else:
            @rt.remote(num_cpus=1, resources={"scale_res": 1})
            class Pinned:
                def ids(self):
                    return ([], None)

        t0 = time.time()
        actor = Pinned.remote()
        out["ids"] = rt.get(actor.ids.remote(), timeout=120)
        out["up_s"] = time.time() - t0
        nodes = [n for n in rt.nodes()
                 if n["Alive"] and n["Resources"].get(scaled_key)]
        out["scaled_nodes"] = len(nodes)
        out["labels"] = sorted(k for k in nodes[0]["Resources"]
                               if k.startswith("accelerator_type:"))
        out["launched"] = cluster.autoscaler.launched_total
        node_ids = [i.node_id_hex for i in
                    cluster.provider.non_terminated_nodes()]
        rt.kill(actor)
        t0 = time.time()
        deadline = t0 + 60
        # a drained node leaves the cluster's resources before the
        # autoscaler terminates its instance, and the provider drops the
        # instance before the autoscaler counts it
        while time.time() < deadline and (
                scaled_key in rt.cluster_resources()
                or cluster.provider.non_terminated_nodes()
                or cluster.autoscaler.terminated_total < 1
                or (port and any(_node_pids(n) for n in node_ids))):
            time.sleep(0.25)
        out["down_s"] = time.time() - t0
        out["after"] = scaled_key in rt.cluster_resources()
        out["terminated"] = cluster.autoscaler.terminated_total
        out["provider_left"] = len(cluster.provider.non_terminated_nodes())
        out["node_ids"] = node_ids
        # the node's agent and the workers it forked are gone before the
        # head stops (C13)
        out["node_pids"] = [p for n in node_ids for p in _node_pids(n)]

        request_resources = importlib.import_module(
            f"{pkg}.autoscaler").request_resources
        w = importlib.import_module(f"{pkg}._private.worker").global_worker()
        out["requested"] = request_resources(bundles=[{"CPU": 4}] * 2)
        out["standing"] = w.request_gcs(
            {"t": "autoscaler_state"})["demands"].count({"CPU": 4.0})
        request_resources()
        out["cleared"] = {"CPU": 4.0} in w.request_gcs(
            {"t": "autoscaler_state"})["demands"]
    finally:
        cluster.shutdown()
    return out


def _node_pids(node_id_hex: str):
    """Live processes of the port node with this id."""
    from ray_tpu_torch._private.node import pids_with_env

    return pids_with_env(f"RAY_TPU_TORCH_NODE_ID={node_id_hex}")


@pytest.fixture(scope="module")
def scaled():
    """Both packages' scale-up/scale-down scenarios, run at once, each on
    a session root of its own that is removed afterwards."""
    from ray_tpu_torch._private.node import session_leftovers

    import ray_tpu
    import ray_tpu_torch

    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    roots = {"RAY_TPU_TMPDIR": _short_root(),
             "RAY_TPU_TORCH_TMPDIR": _short_root()}
    saved = {k: os.environ.get(k) for k in roots}
    os.environ.update(roots)
    results = {}

    def run(pkg):
        try:
            results[pkg] = _scale_scenario(pkg)
        except BaseException as e:  # noqa: BLE001 - reported below
            results[pkg] = e

    try:
        threads = [threading.Thread(target=run, args=(p,))
                   for p in PACKAGES]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        port_root = roots["RAY_TPU_TORCH_TMPDIR"]
        deadline = time.time() + 20
        while session_leftovers(port_root) != ([], []) and \
                time.time() < deadline:
            time.sleep(0.2)
        results["leftovers"] = session_leftovers(port_root)
        yield results
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for root in roots.values():
            shutil.rmtree(root, ignore_errors=True)


def _result(scaled, pkg):
    out = scaled[pkg]
    if isinstance(out, BaseException):
        raise out
    return out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_autoscaling_cluster_scales_up_on_demand(scaled, pkg):
    out = _result(scaled, pkg)
    assert out["before"] is False
    assert out["launched"] == 1 and out["scaled_nodes"] == 1
    if pkg == "ray_tpu_torch":
        # the actor that asked for the card is pinned to the new host's
        assert out["ids"] == (["0"], "0")
        assert out["labels"] == ["accelerator_type:H100"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_autoscaling_cluster_scales_down_when_idle(scaled, pkg):
    out = _result(scaled, pkg)
    assert out["after"] is False, "idle node was never terminated"
    assert out["terminated"] == 1 and out["provider_left"] == 0
    if pkg == "ray_tpu_torch":
        assert out["node_ids"] and out["node_pids"] == []


def test_autoscaling_clusters_leave_nothing_behind(scaled):
    _result(scaled, "ray_tpu_torch")
    assert scaled["leftovers"] == ([], [])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_request_resources_is_standing_demand(scaled, pkg):
    out = _result(scaled, pkg)
    assert out["requested"] == 2 and out["standing"] == 2
    assert out["cleared"] is False


# -------------------------------------------- GCP GPU provider, launcher


class RecordedCloud:
    """Scripted gcloud/ssh executor: records argv, plays back state."""

    def __init__(self):
        self.calls = []
        self.nodes = {}  # name -> instance dict

    def __call__(self, argv, timeout=None):
        self.calls.append(list(argv))
        if argv[0] == "gcloud":
            assert argv[1:3] == ["compute", "instances"], argv
            op = argv[3]
            if op == "create":
                name = argv[4]
                machine = next(a.split("=", 1)[1] for a in argv
                               if a.startswith("--machine-type="))
                self.nodes[name] = {
                    "name": name, "status": "RUNNING",
                    "machineType": f"zones/z/machineTypes/{machine}",
                    "networkInterfaces": [
                        {"networkIP": "10.0.0.1",
                         "accessConfigs": [{"natIP": "34.1.2.3"}]}],
                }
                return json.dumps([self.nodes[name]])
            if op == "delete":
                self.nodes.pop(argv[4], None)
                return "[]"
            if op == "list":
                return json.dumps(list(self.nodes.values()))
            if op == "describe":
                return json.dumps(self.nodes.get(argv[4], {}))
            raise AssertionError(f"unexpected gcloud op {op}")
        return "ok\n"  # ssh/scp/cp land here


def test_gpu_machine_types_carry_their_cards():
    from ray_tpu_torch.autoscaler import gcp

    assert gcp._gpus_of("a3-highgpu-8g") == ("nvidia-h100-80gb", 8, "H100")
    assert gcp._node_resources("a3-highgpu-1g") == {
        "GPU": 1.0, "accelerator_type:H100": 1.0}
    assert gcp._node_resources("a2-ultragpu-8g") == {
        "GPU": 8.0, "accelerator_type:A100-80G": 1.0}
    with pytest.raises(ValueError, match="unknown GPU machine type"):
        gcp._gpus_of("n2-standard-8")


def test_gpu_provider_create_list_terminate():
    from ray_tpu_torch.autoscaler.gcp import GCPGPUNodeProvider

    fake = RecordedCloud()
    prov = GCPGPUNodeProvider(project="p", zone="z",
                              machine_type="a3-highgpu-8g", name_prefix="t",
                              exec_fn=fake, preemptible=True)
    inst = prov.create_node("gpu_worker", {"CPU": 208})
    assert inst.instance_id.startswith("t-")
    assert inst.resources == {"CPU": 208, "GPU": 8.0,
                              "accelerator_type:H100": 1.0}
    create = fake.calls[0]
    assert create[:5] == ["gcloud", "compute", "instances", "create",
                          inst.instance_id]
    for arg in ("--machine-type=a3-highgpu-8g",
                "--accelerator=type=nvidia-h100-80gb,count=8",
                "--maintenance-policy=TERMINATE",
                "--provisioning-model=SPOT",
                "--project=p", "--zone=z", "--format=json", "--quiet"):
        assert arg in create, (arg, create)

    live = prov.non_terminated_nodes()
    assert [n.instance_id for n in live] == [inst.instance_id]
    listing = fake.calls[-1]
    assert listing[3] == "list" and "--zones=z" in listing
    assert not any(a.startswith("--zone=") for a in listing)

    assert prov.address(inst.instance_id) == "10.0.0.1"
    assert prov.address(inst.instance_id, internal=False) == "34.1.2.3"
    assert prov.wait_ready(inst.instance_id, timeout=1)
    runner = prov.command_runner(inst.instance_id, ssh_user="u",
                                 exec_fn=fake)
    runner.run("nvidia-smi")
    assert fake.calls[-1][-2:] == ["u@10.0.0.1", "nvidia-smi"]

    # a VM the provider did not create itself is listed with its type's
    # cards; a spot VM the cloud took back is gone
    fake.nodes["t-other"] = dict(fake.nodes[inst.instance_id],
                                 name="t-other",
                                 machineType="zones/z/machineTypes/"
                                 "a3-highgpu-2g")
    fake.nodes[inst.instance_id]["status"] = "TERMINATED"
    (other,) = prov.non_terminated_nodes()
    assert other.instance_id == "t-other"
    assert other.resources == {"GPU": 2.0, "accelerator_type:H100": 1.0}

    prov.terminate_node("t-other")
    prov.terminate_node(inst.instance_id)
    assert prov.non_terminated_nodes() == []
    assert all("--project=p" in c for c in fake.calls if c[0] == "gcloud")


def test_ssh_runner_uses_key():
    from ray_tpu_torch.autoscaler.command_runner import SSHCommandRunner

    fake = RecordedCloud()
    r = SSHCommandRunner("1.2.3.4", ssh_user="ray", ssh_key="/k",
                         exec_fn=fake)
    r.run("ls")
    assert "-i" in fake.calls[-1] and "/k" in fake.calls[-1]
    r.run_rsync_up("/src", "/dst")
    assert fake.calls[-1][0] == "scp"


def test_local_command_runner_real_exec(tmp_path):
    from ray_tpu_torch.autoscaler.command_runner import LocalCommandRunner

    out = LocalCommandRunner().run(
        f"echo hello > {tmp_path}/x && cat {tmp_path}/x")
    assert out.strip() == "hello"


CLUSTER = {
    "cluster_name": "myclus",
    "provider": {"type": "gcp_gpu", "project": "p", "zone": "z",
                 "machine_type": "a3-highgpu-8g"},
    "auth": {"ssh_user": "ray"},
    "file_mounts": {"/app": "/tmp"},
    "head_setup_commands": ["pip install -e /app"],
}


def test_launcher_up_down():
    from ray_tpu_torch.autoscaler import launcher

    fake = RecordedCloud()
    out = launcher.up(CLUSTER, exec_fn=fake)
    assert out["head_ip"] == "10.0.0.1"
    assert out["num_hosts"] == 1 and out["num_gpus"] == 8.0
    joined = [" ".join(c) for c in fake.calls]
    assert sum("pip install -e /app" in j for j in joined) == 1
    assert any(j.startswith("scp") and "ray@10.0.0.1:/app" in j
               for j in joined)
    (head,) = [j for j in joined if "--head" in j]
    assert "ray@10.0.0.1" in head
    assert "RAY_TPU_TORCH_HEAD_IP=10.0.0.1" in head
    assert "python -m ray_tpu_torch start --head --port 6379" in head
    assert not any("--address" in j for j in joined)

    killed = launcher.down(CLUSTER, exec_fn=fake)
    assert killed == [out["head_instance"]]
    assert fake.nodes == {}


def test_launcher_rejects_unknown_provider():
    from ray_tpu_torch.autoscaler import launcher

    with pytest.raises(ValueError, match="not supported"):
        launcher.up({"provider": {"type": "gcp_tpu"}},
                    exec_fn=RecordedCloud())


def test_provider_requires_gcloud_without_exec(monkeypatch):
    from ray_tpu_torch.autoscaler.gcp import GCPGPUNodeProvider

    monkeypatch.setattr(shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="gcloud CLI not found"):
        GCPGPUNodeProvider(project="p", zone="z")


def test_cli_up_and_down_on_a_recorded_cloud(monkeypatch, tmp_path, capsys):
    """``python -m ray_tpu_torch up``/``down`` call the launcher (the
    recorded cloud stands in for gcloud and ssh); ``check`` still waits
    for the static checks."""
    import yaml

    from ray_tpu_torch import scripts
    from ray_tpu_torch.autoscaler import command_runner, gcp

    fake = RecordedCloud()
    monkeypatch.setattr(gcp, "_default_exec", fake)
    monkeypatch.setattr(command_runner, "_default_exec", fake)
    monkeypatch.setattr(shutil, "which", lambda name: f"/usr/bin/{name}")
    config = tmp_path / "cluster.yaml"
    config.write_text(yaml.safe_dump(CLUSTER))

    scripts.main(["up", str(config)])
    (name,) = fake.nodes
    assert f"head {name} at 10.0.0.1 (1 host(s))" in capsys.readouterr().out
    assert any("--head" in " ".join(c) for c in fake.calls)

    scripts.main(["down", str(config)])
    assert f"terminated 1 instance(s): {name}" in capsys.readouterr().out
    assert fake.nodes == {}

    with pytest.raises(NotImplementedError, match="ROADMAP A13b"):
        scripts.main(["check", "ray_tpu_torch"])


# -------------------------------------------------- GCE preemption source


class _Metadata(http.server.BaseHTTPRequestHandler):
    values = {}
    flavors = []

    def do_GET(self):
        self.flavors.append(self.headers.get("Metadata-Flavor"))
        key = self.path.rsplit("/", 1)[-1]
        body = self.values.get(key)
        if body is None:
            self.send_response(404)
            self.end_headers()
            return
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


@pytest.fixture
def metadata_server(monkeypatch):
    """A local stand-in for GCE's metadata server; the source's ``BASE``
    points at it (no proxy may take the request elsewhere)."""
    from ray_tpu_torch._private import node

    for var in ("http_proxy", "HTTP_PROXY", "all_proxy", "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Metadata)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    monkeypatch.setattr(
        node.GceMetadataPreemptionSource, "BASE",
        f"http://127.0.0.1:{server.server_port}"
        "/computeMetadata/v1/instance/")
    _Metadata.values = {}
    _Metadata.flavors = []
    try:
        yield _Metadata
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("values,want", [
    ({"preempted": "TRUE", "maintenance-event": "NONE"},
     "gce preemption: TRUE"),
    ({"preempted": "FALSE",
      "maintenance-event": "TERMINATE_ON_HOST_MAINTENANCE"},
     "gce maintenance: TERMINATE_ON_HOST_MAINTENANCE"),
    ({"preempted": "false", "maintenance-event": "none"}, None),
    ({"preempted": "FALSE"}, None),
])
def test_gce_source_reads_both_keys(metadata_server, values, want):
    from ray_tpu_torch._private.node import GceMetadataPreemptionSource

    metadata_server.values = values
    notice = GceMetadataPreemptionSource().poll()
    if want is None:
        assert notice is None
    else:
        assert notice == {"reason": want, "deadline_s": None}
    assert metadata_server.flavors
    assert set(metadata_server.flavors) == {"Google"}


def test_gce_source_reads_nothing_from_an_unreachable_host(monkeypatch):
    from ray_tpu_torch._private import node

    for var in ("http_proxy", "HTTP_PROXY", "all_proxy", "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens there now
    monkeypatch.setattr(node.GceMetadataPreemptionSource, "BASE",
                        f"http://127.0.0.1:{port}/")
    assert node.GceMetadataPreemptionSource().poll() is None


def test_the_gce_setting_builds_the_gce_source(monkeypatch, tmp_path):
    from ray_tpu_torch._private import node
    from ray_tpu_torch._private.ids import NodeID

    for kind, cls in (("gce", node.GceMetadataPreemptionSource),
                      ("file", node.FilePreemptionSource)):
        monkeypatch.setattr(node, "_cfg", lambda kind=kind: SimpleNamespace(
            preemption_notice_source=kind, preemption_notice_file=""))
        src = node.make_preemption_source(NodeID.from_random(),
                                          str(tmp_path))
        assert type(src) is cls


# ------------------------------------------- the autoscaler's GCS client


def test_the_frame_counter_waits_for_a_recorder_still_importing(
        monkeypatch):
    """C14: the protocol binds the plane-event recorder only once its
    module has run. The autoscaler's thread connects a client of its own,
    and a driver connecting at the same moment read the recorder module
    while that thread was still importing it (AttributeError)."""
    import sys
    import types

    from ray_tpu_torch._private import protocol

    partial = types.ModuleType("ray_tpu_torch.util.events")
    partial.__spec__ = SimpleNamespace(_initializing=True)
    partial._enabled = False
    monkeypatch.setattr(protocol, "_plane_events", None)
    monkeypatch.setitem(sys.modules, "ray_tpu_torch.util.events", partial)
    assert protocol._events() is None
    assert protocol._plane_events is None
    partial.__spec__._initializing = False
    assert protocol._events() is partial


# ---------------------------------------------------------------- copies

# Copied from the reference with only their names changed; the node
# provider, the GCP provider, the command runners, the launcher and the
# AutoscalingCluster carry GPUs in place of TPU slices (CHANGES.md).
VERBATIM = ("autoscaler/autoscaler.py", "autoscaler/scheduler.py",
            "autoscaler/instance_manager.py")


def _renamed(text: str) -> str:
    text = re.sub(r"\bray_tpu\b(?!_torch)", "ray_tpu_torch", text)
    text = re.sub(r"\bRAY_TPU_(?!TORCH_)", "RAY_TPU_TORCH_", text)
    return re.sub(r"\brtpu", "rtpt", text)


def _code(text: str) -> str:
    """The module's syntax tree without docstrings."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
    return ast.dump(tree)


def _defs(path: Path, names, renamed: bool = False):
    text = path.read_text()
    if renamed:
        text = _renamed(text)
    tree = ast.parse(text)
    found = {n.name: n for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             and n.name in names}
    assert sorted(found) == sorted(names), (path, sorted(found))
    return [_code(ast.unparse(found[n])) for n in names]


@pytest.mark.parametrize("module", VERBATIM)
def test_autoscaler_copy_is_the_reference_code_but_for_names(module):
    got = (REPO / "ray_tpu_torch" / module).read_text()
    want = _renamed((REPO / "ray_tpu" / module).read_text())
    assert _code(got) == _code(want)


@pytest.mark.parametrize("module,names", [
    ("autoscaler/__init__.py", ["request_resources"]),
    ("autoscaler/node_provider.py",
     ["NodeInstance", "NodeProvider", "LocalNodeProvider"]),
    ("autoscaler/command_runner.py",
     ["CommandRunner", "_default_exec", "LocalCommandRunner",
      "SSHCommandRunner"]),
    ("autoscaler/launcher.py", ["load_config", "down"]),
    ("_private/node.py", ["GceMetadataPreemptionSource"]),
])
def test_the_kept_definitions_are_the_reference_code(module, names):
    assert _defs(REPO / "ray_tpu_torch" / module, names) == \
        _defs(REPO / "ray_tpu" / module, names, renamed=True)
