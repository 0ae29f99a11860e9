"""Job Executor (§4.1.2): bridges scheduling decisions to runtime launch.

Builds the pod-spec analogue — the environment that restricts a worker's
visibility to its assigned leaves (``NVIDIA_VISIBLE_DEVICES`` = MIG UUIDs)
— and performs the per-process init of §4.2 (export to
``CUDA_VISIBLE_DEVICES`` + ``NCCL_MIG_ID``), then forms the communicator
through the MIG-aware registry.  This is the end-to-end wiring the paper's
Fig. 4/5 describe, runnable in-process.

The port's copy of ``repro/core/executor.py``: the same code, with the
port's imports; a pod's entry point is the port's training launcher.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.job import Job, Placement
from repro_torch.core.registry import (PeerInfo, env_to_peer,
                                       form_communicator, select_transport)


@dataclasses.dataclass
class PodSpec:
    job_id: str
    env: Dict[str, str]
    n_workers: int
    entrypoint: str = "python -m repro_torch.launch.train"


@dataclasses.dataclass
class LaunchedJob:
    pod: PodSpec
    peers: List[PeerInfo]
    transports: Dict[tuple, str]


class JobExecutor:
    """Prepares pod specs and launches distributed workers."""

    def pod_spec(self, job: Job, placement: Placement) -> PodSpec:
        uuids = ",".join(i.uuid for i in placement.instances)
        return PodSpec(
            job_id=job.job_id,
            env={"NVIDIA_VISIBLE_DEVICES": uuids},
            n_workers=len(placement.instances),
        )

    def launch(self, job: Job, placement: Placement,
               *, mig_aware: bool = True) -> LaunchedJob:
        pod = self.pod_spec(job, placement)
        uuids = pod.env["NVIDIA_VISIBLE_DEVICES"].split(",")
        peers: List[PeerInfo] = []
        for local_rank, (uuid, inst) in enumerate(
                zip(uuids, placement.instances)):
            # per-process init (§4.2): LOCAL_RANK selects this worker's UUID
            worker_env = dict(pod.env)
            worker_env["NVIDIA_VISIBLE_DEVICES"] = uuid
            gpu_bus = f"00:{0x40 + inst.gpu_id:02X}:00.0"
            peers.append(env_to_peer(
                local_rank, worker_env,
                host_hash=hash(("host", inst.host_id)) & 0xffffffff,
                pid_hash=local_rank + 1000,
                pcie_bus_id=gpu_bus))
        # communicator setup with the Flex-MIG NCCL modifications
        form_communicator(peers, mig_aware=mig_aware,
                          synthetic_labeling=mig_aware)
        transports = {}
        for a in peers:
            for b in peers:
                if a.rank < b.rank:
                    transports[(a.rank, b.rank)] = select_transport(a, b)
        return LaunchedJob(pod=pod, peers=peers, transports=transports)
