from setuptools import setup, find_packages

exec(open("coolpuppy_tpu/_version.py").read())

setup(
    name="coolpuppy-tpu",
    version=__version__,  # noqa: F821
    description="Accelerator-native sparse pile-up (APA) engine for Hi-C data",
    packages=find_packages(
        include=[
            "coolpuppy_tpu",
            "coolpuppy_tpu.*",
            # import-compat shim mapping the reference's module surface
            # (coolpuppy.coolpup / plotpup / lib.*) onto coolpuppy_tpu;
            # do not install alongside the original coolpuppy
            "coolpuppy",
            "coolpuppy.*",
        ]
    ),
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "pandas",
        "scipy",
        "h5py",
        "jax",
        "matplotlib",
    ],
    entry_points={
        "console_scripts": [
            "coolpup-tpu = coolpuppy_tpu.cli.coolpup_cli:main",
            "plotpup-tpu = coolpuppy_tpu.cli.plotpup_cli:main",
            "dividepups-tpu = coolpuppy_tpu.cli.dividepups_cli:main",
            # drop-in aliases matching the reference's script names
            # (reference setup.py:55-61); do not install alongside the
            # original coolpuppy
            "coolpup.py = coolpuppy_tpu.cli.coolpup_cli:main",
            "plotpup.py = coolpuppy_tpu.cli.plotpup_cli:main",
            "dividepups.py = coolpuppy_tpu.cli.dividepups_cli:main",
        ]
    },
)
