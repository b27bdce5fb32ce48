"""The input-file index pickle that ``PhysicsDataset`` reads, the port's counterpart of
``tools/generate_input_map.py``:

    python -m deepphysinet_tpu_torch.tools.generate_input_map --data_path TREE/input/NCEP
        --result_file MAP.pickle [--start_time %Y-%m-%d-%H:%M:%S] [--end_time ...] [--step_hours 12]
        [--max_lead 360]

Walks ``<data_path>/<year>/*.tiff``; an init time every ``--step_hours`` enters the index when every
(variable, lead) pair of it is present, each ``GFS_%Y-%m-%d-%H-%M-%S_f%03d_<var>`` mapped to its
path relative to the input root (``<mode>/<year>/<name>``, no extension).  ``main(argv)`` returns
the index and the incomplete init times.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import pickle
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from deepphysinet_tpu_torch.utils import path_utils

VARIABLE_LIST = ["PSFC", "t2", "q2", "u10", "v10", "rio", "UU", "VV", "TT", "GHT", "QQ"]


def build_input_map(data_path, start_time, end_time, step_hours=12, lead_list=None, variable_list=None):
    lead_list = lead_list or list(range(0, 361, 6))
    variable_list = variable_list or VARIABLE_LIST
    query = {}
    for f in glob.glob(os.path.join(data_path, "*", "*.tiff")):
        query[path_utils.get_filename(f, is_suffix=False)] = f

    result, missing = {}, []
    t = start_time
    while t <= end_time:
        date_str = t.strftime("%Y-%m-%d-%H-%M-%S")
        names = [f"GFS_{date_str}_f{lead:03d}_{v}" for v in variable_list for lead in lead_list]
        if all(n in query for n in names):
            for n in names:
                f = query[n]
                parent = path_utils.get_parent_folder(f, with_root=True)
                result[n] = os.path.join(
                    path_utils.get_parent_folder(parent, with_root=False),
                    path_utils.get_parent_folder(f, with_root=False),
                    path_utils.get_filename(f, is_suffix=False),
                )
        else:
            missing.append(t)
        t += datetime.timedelta(hours=step_hours)
    return result, missing


def main(argv: Optional[Sequence[str]] = None) -> Tuple[Dict[str, str], List[datetime.datetime]]:
    """Run the tool; returns the index written and the incomplete init times."""
    parser = argparse.ArgumentParser("the input-file index of a GeoTIFF tree")
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--result_file", type=str, required=True)
    parser.add_argument("--start_time", type=str, default="2007-01-01-00:00:00")
    parser.add_argument("--end_time", type=str, default="2020-12-31-12:00:00")
    parser.add_argument("--step_hours", type=int, default=12)
    parser.add_argument("--max_lead", type=int, default=360)
    args = parser.parse_args(argv)
    start = datetime.datetime.strptime(args.start_time, "%Y-%m-%d-%H:%M:%S")
    end = datetime.datetime.strptime(args.end_time, "%Y-%m-%d-%H:%M:%S")
    result, missing = build_input_map(args.data_path, start, end, args.step_hours,
                                      lead_list=list(range(0, args.max_lead + 1, 6)))
    print(f"indexed {len(result)} files; {len(missing)} incomplete init times")
    with open(args.result_file, "wb") as fp:
        pickle.dump(result, fp)
    return result, missing


if __name__ == "__main__":
    main(sys.argv[1:])
