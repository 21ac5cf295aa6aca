"""Analytical performance model of PAM and its baselines (paper §7.1),
counterpart of ``repro.perfmodel``: the latency models a cluster's
engines run their modeled clocks on. Its seconds are the simulated PIM
hardware's, not the GPU's."""

from repro_torch.perfmodel.devices import (DEVICE_CLASSES, DeviceClass,
                                           get_device_class,
                                           make_device_latency_model,
                                           parse_devices,
                                           replica_group_class,
                                           step_time_prior)
from repro_torch.perfmodel.latency import make_latency_model
from repro_torch.perfmodel.model import (PAM_LLAMA_7B, StepWorkload,
                                         SystemKind, SystemModel,
                                         make_system, simulate_decode_step,
                                         simulate_offline, simulate_online)

__all__ = ["DEVICE_CLASSES", "DeviceClass", "PAM_LLAMA_7B", "StepWorkload",
           "SystemKind", "SystemModel", "get_device_class",
           "make_device_latency_model", "make_latency_model", "make_system",
           "parse_devices", "replica_group_class", "simulate_decode_step",
           "simulate_offline", "simulate_online", "step_time_prior"]
