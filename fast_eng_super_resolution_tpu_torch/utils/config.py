"""Config/flag system — reference CLI surface (utils.py:19-88).

Same argparse flags, same two-YAML-file convention (exp_config splatted as
``**kwargs`` into every factory, run_ALDS_3D.py:63-66), same defaults.
"""

from __future__ import annotations

import argparse
import time

import yaml


def load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.load(f, Loader=yaml.FullLoader)


def get_cur_time() -> str:
    return time.strftime("%m-%d-%H-%M", time.localtime())


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run ALDS experiment")
    parser.add_argument("--dataset", type=str, default="ansys",
                        help="Name of the dataset")
    parser.add_argument("--encoder", type=str, default="pca",
                        help="Name of the encoder")
    parser.add_argument("--classifier", type=str, default="kmeans",
                        help="Name of the classifier")
    parser.add_argument("--model", type=str, default="neuralop",
                        help="Name of the model")
    parser.add_argument("--exp_name", type=str, default="ansys_neuralop",
                        help="Name of the experiment")
    parser.add_argument("--mode", type=str, default="pred",
                        help="Mode of the experiment")
    parser.add_argument("--exp_config", type=str,
                        default="configs/exp_config/teecnet_ansys.yaml",
                        help="Path to the experiment configuration file")
    parser.add_argument("--train_config", type=str,
                        default="configs/train_config/teecnet.yaml",
                        help="Path to the training configuration file")
    return parser.parse_args(argv)
