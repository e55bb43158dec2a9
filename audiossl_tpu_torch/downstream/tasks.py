"""LAPE downstream task registry (port of ``audiossl_tpu.downstream.tasks``).

Host code only: each task is CSVs with (audio-path, label) columns under a
task root, a fixed or derived label vocabulary and a clip duration, taken
from the reference's per-task datasets (extras/datasets/*_avg.py):

  * durations: sc v1/v2/v2-35 = 1 s (speech_commands_v2_avg.py:13),
    birdsong 10 s (birdsong_dataset_avg.py:14), iemocap 4 s, libri100 13 s,
    musical_instruments 4 s, tut_urban 9 s, voxceleb 8 s, lid 6 s;
  * label columns: 'Label' for most, 'label' for sc-v1/voxceleb,
    'Label_id' for iemocap/libri100 (pre-assigned integer ids);
  * CSV names: train_data.csv/test_data.csv except voxceleb
    (train_vox.csv/test_vox.csv — voxceleb_avg.py:20,48) and the
    single-CSV tasks birdsong (combined_data.csv) and lid
    (complete_lid.csv), which split 80/20 stratified with random_state=1
    (birdsong_dataset_avg.py:16, language_identification_avg.py:15);
  * libri100 joins audio paths under a wav/ subdir (libri100_avg.py:30);
  * fixed vocabularies: the 12-word speech-commands dict, the 35-word
    v2 dict in its exact insertion order (speech_commands_v2_avg_35.py:21),
    TUT's 10 scenes (tut_urban_sounds_avg.py:21-23), LID's 6 languages,
    IEMOCAP's 4 emotions.

Task roots come from the AUDIOSSL_DATA_ROOT env var or explicit CLI paths.
The loaders are the port's ``data.pipeline.ManifestLoader``.
"""
from __future__ import annotations

import dataclasses
import os


SPEECH_COMMANDS_12 = {
    "unknown": 0, "down": 1, "go": 2, "silence": 3, "on": 4, "stop": 5,
    "left": 6, "no": 7, "up": 8, "yes": 9, "off": 10, "right": 11,
}

# speech_commands_v2_avg_35.py:21 — exact order defines the ids
SPEECH_COMMANDS_35 = dict(
    zip(
        [
            "sheila", "left", "four", "up", "stop", "off", "dog", "go",
            "three", "cat", "follow", "wow", "down", "two", "happy", "six",
            "one", "eight", "on", "five", "bird", "nine", "yes", "marvin",
            "tree", "learn", "seven", "zero", "right", "no", "visual",
            "backward", "forward", "bed", "house",
        ],
        range(35),
    )
)

IEMOCAP_4 = {"neu": 0, "ang": 1, "sad": 2, "hap": 3}  # iemocap_avg.py:21

TUT_URBAN_10 = {  # tut_urban_sounds_avg.py:21-23
    "airport": 0, "bus": 1, "metro": 2, "metro_station": 3, "park": 4,
    "public_square": 5, "shopping_mall": 6, "street_pedestrian": 7,
    "street_traffic": 8, "tram": 9,
}

LID_6 = {  # language_identification_avg.py:22
    "french": 0, "spanish": 1, "german": 2, "russian": 3, "english": 4, "italian": 5,
}


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    subdir: str
    train_csv: str = "train_data.csv"
    test_csv: str = "test_data.csv"
    valid_csv: str | None = None
    split_csv: str | None = None  # single combined CSV: 80/20 stratified split
    file_col: str = "AudioPath"
    label_col: str = "Label"
    path_extra: str = ""  # extra dir joined between root and AudioPath
    duration: float = 1.0  # seconds per clip window
    labels: dict | None = None  # fixed vocabulary, else derived from train CSV
    metric: str = "accuracy"

    def resolve(self, root: str | None) -> tuple[str, str, str | None]:
        base = self.base(root)
        return (
            os.path.join(base, self.train_csv),
            os.path.join(base, self.test_csv),
            os.path.join(base, self.valid_csv) if self.valid_csv else None,
        )

    def base(self, root: str | None) -> str:
        root = root or os.environ.get("AUDIOSSL_DATA_ROOT", ".")
        return os.path.join(root, self.subdir)


TASKS: dict[str, TaskSpec] = {
    t.name: t
    for t in [
        # speech_commands_v1_avg.py: config-driven duration (run.duration=1),
        # lowercase 'label' column, 12-word vocab
        TaskSpec("speech_commands_v1", "speechv1", label_col="label", labels=SPEECH_COMMANDS_12),
        TaskSpec("speech_commands_v2", "speechv2/train", labels=SPEECH_COMMANDS_12),
        TaskSpec("speech_commands_v2_35", "speech_cmd_v2_data", labels=SPEECH_COMMANDS_35),
        TaskSpec("birdsong_combined", "Bird_audio", split_csv="combined_data.csv", duration=10.0),
        # Label_id carries pre-assigned integer ids (iemocap_avg.py:41); the
        # 4-emotion vocab (IEMOCAP_4) is informational in the reference too
        TaskSpec("iemocap", "iemocap/IEMOCAP", label_col="Label_id", duration=4.0),
        TaskSpec("libri_100", "libri100", label_col="Label_id", path_extra="wav", duration=13.0),
        TaskSpec("musical_instruments", "magenta", duration=4.0),
        TaskSpec(
            "tut_urban", "TUT-urban-acoustic-scenes-2018-development",
            duration=9.0, labels=TUT_URBAN_10,
        ),
        TaskSpec(
            "voxceleb_v1", "voxceleb", train_csv="train_vox.csv", test_csv="test_vox.csv",
            file_col="file_path", label_col="label", duration=8.0,
        ),
        TaskSpec("language_identification", "audio", split_csv="complete_lid.csv", duration=6.0, labels=LID_6),
    ]
}


def get_task(name: str) -> TaskSpec | None:
    return TASKS.get(name)


def build_task_loaders(
    task: TaskSpec,
    batch: int,
    sr: int,
    workers: int = 8,
    data_root: str | None = None,
    train_csv: str | None = None,
    test_csv: str | None = None,
    valid_csv: str | None = None,
    balanced: bool = False,  # train-split inverse-class-frequency sampling
):
    """(train, valid, test, clip_samples) loaders with the task's reference
    semantics: duration window, label vocabulary, CSV layout, path joins,
    and the 80/20 stratified split for single-CSV tasks."""
    from audiossl_tpu_torch.data.pipeline import ManifestLoader

    clip = int(task.duration * sr)
    base = task.base(data_root)
    prefix = os.path.join(base, task.path_extra) if task.path_extra else base
    common = dict(
        labeled=True, file_col=task.file_col, label_col=task.label_col, path_prefix=prefix
    )

    if task.split_csv and not train_csv:
        import pandas as pd
        from sklearn.model_selection import train_test_split

        df = pd.read_csv(os.path.join(base, task.split_csv))
        # birdsong_dataset_avg.py:16 / language_identification_avg.py:15
        train_df, test_df = train_test_split(
            df, test_size=0.2, random_state=1, stratify=df[task.label_col]
        )
        train = ManifestLoader(
            train_df, batch, clip, sr, shuffle=True, num_workers=workers, seed=1,
            labels_map=task.labels, balanced=balanced, **common,
        )
        test = ManifestLoader(
            test_df, batch, clip, sr, shuffle=False, drop_last=False,
            num_workers=workers, labels_map=train.label_to_id, **common,
        )
        return train, None, test, clip

    t_train, t_test, t_valid = task.resolve(data_root)
    train_csv = train_csv or t_train
    test_csv = test_csv or t_test
    valid_csv = valid_csv or t_valid
    train = ManifestLoader(
        train_csv, batch, clip, sr, shuffle=True, num_workers=workers, seed=1,
        labels_map=task.labels, balanced=balanced, **common,
    )
    test = ManifestLoader(
        test_csv, batch, clip, sr, shuffle=False, drop_last=False,
        num_workers=workers, labels_map=train.label_to_id, **common,
    )
    valid = None
    if valid_csv and os.path.exists(valid_csv):
        valid = ManifestLoader(
            valid_csv, batch, clip, sr, shuffle=False, drop_last=False,
            num_workers=4, labels_map=train.label_to_id, **common,
        )
    return train, valid, test, clip
