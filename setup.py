"""Install: pip install -e .  (console script: skytpu)"""
from setuptools import find_packages, setup

setup(
    name='skypilot-tpu',
    version='0.1.0',
    description='TPU-native cloud orchestration + JAX workload framework',
    packages=find_packages(include=['skypilot_tpu', 'skypilot_tpu.*',
                                    'skypilot_tpu_torch',
                                    'skypilot_tpu_torch.*']),
    package_data={'skypilot_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh']},
    python_requires='>=3.10',
    install_requires=[
        'click', 'filelock', 'jsonschema', 'networkx', 'pandas', 'psutil',
        'pyyaml', 'requests', 'jinja2',
    ],
    extras_require={
        'tpu': ['jax', 'flax', 'optax', 'orbax-checkpoint', 'einops'],
        'serve': ['aiohttp', 'httpx'],
        'gcp': ['google-auth'],
    },
    entry_points={'console_scripts': ['skytpu = skypilot_tpu.cli:main']},
)
