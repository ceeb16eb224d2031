"""PyTorch/CUDA port of kazen_tpu for NVIDIA Hopper.

The layout mirrors ``kazen_tpu`` module for module (``core``, ``samplers``,
``scene``, ``accel``, ``shade``, ``integrate``, ``film``, ``diff``,
``dist``, ``cli``, ``utils``), with the measuring scripts under ``lab``
and BASELINE.json's configurations under ``examples``. Plain tensor code is
PyTorch; the kernels are CUDA C++ (the cluster-BVH trace under
``accel/csrc``, the path_mis megakernel under ``integrate/csrc``, the lab
probes of ``benchmarks/`` under ``lab/csrc``), built with ``nvcc`` at first
use into ``build/`` (``cuda_build.py``).

Entry points (``scene.compiler.compile_scene``, ``integrate.render.render``,
``diff.inverse.optimize``, ``python -m kazen_tpu_torch.cli``) run on
``device="cuda"`` unless the caller passes ``device="cpu"``, where every
kernel is replaced by its plain PyTorch version.
"""
