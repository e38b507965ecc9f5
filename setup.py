from setuptools import find_packages, setup

setup(
    name="deepspeed_tpu",
    version="0.5.0",
    description="TPU-native large-model training & inference framework (DeepSpeed-capability, JAX/XLA/Pallas)",
    packages=find_packages(
        include=["deepspeed_tpu", "deepspeed_tpu.*", "deepspeed_tpu_torch", "deepspeed_tpu_torch.*"]
    ),
    package_data={"deepspeed_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "optax", "orbax-checkpoint", "numpy"],
    entry_points={
        "console_scripts": [
            "deepspeed=deepspeed_tpu.launcher.runner:main",
            "ds_report=deepspeed_tpu.env_report:main",
            "ds_ssh=deepspeed_tpu.launcher.tools:ds_ssh",
            "ds_bench=deepspeed_tpu.launcher.tools:ds_bench",
            "ds_elastic=deepspeed_tpu.launcher.tools:ds_elastic",
        ]
    },
)
