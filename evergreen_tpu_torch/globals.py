"""Constants and enums the packed solve, its snapshot builder and the
store's models read.

A copy of the part of ``evergreen_tpu/globals.py`` this package needs, so
that it imports nothing of the JAX package. ``tests/test_torch_layout.py``
holds the copies equal to the originals.
"""
from __future__ import annotations

import enum


class TaskStatus(str, enum.Enum):
    UNDISPATCHED = "undispatched"
    DISPATCHED = "dispatched"
    STARTED = "started"
    SUCCEEDED = "success"
    FAILED = "failed"
    ABORTED = "aborted"
    INACTIVE = "inactive"
    SYSTEM_FAILED = "system-failed"
    SETUP_FAILED = "setup-failed"
    TIMED_OUT = "task-timed-out"
    BLOCKED = "blocked"
    WILL_RUN = "will-run"


#: statuses in which a task has finished running
TASK_COMPLETED_STATUSES = frozenset(
    {TaskStatus.SUCCEEDED.value, TaskStatus.FAILED.value}
)


class HostStatus(str, enum.Enum):
    UNINITIALIZED = "initializing"  # intent host, not yet materialized
    BUILDING = "building"
    BUILDING_FAILED = "building-failed"
    STARTING = "starting"
    PROVISIONING = "provisioning"
    PROVISION_FAILED = "provision failed"
    RUNNING = "running"
    STOPPING = "stopping"
    STOPPED = "stopped"
    QUARANTINED = "quarantined"
    DECOMMISSIONED = "decommissioned"
    TERMINATED = "terminated"


class BuildStatus(str, enum.Enum):
    CREATED = "created"
    STARTED = "started"
    SUCCEEDED = "success"
    FAILED = "failed"


class VersionStatus(str, enum.Enum):
    CREATED = "created"
    STARTED = "started"
    SUCCEEDED = "success"
    FAILED = "failed"


#: states the allocator counts as active capacity
HOST_ACTIVE_STATUSES = frozenset(
    {
        HostStatus.UNINITIALIZED.value,
        HostStatus.BUILDING.value,
        HostStatus.STARTING.value,
        HostStatus.PROVISIONING.value,
        HostStatus.RUNNING.value,
    }
)


class Requester(str, enum.Enum):
    REPOTRACKER = "gitter_request"  # mainline commit builds
    PATCH = "patch_request"  # CLI patches
    GITHUB_PR = "github_pull_request"
    GITHUB_MERGE = "github_merge_request"  # merge queue
    AD_HOC = "ad_hoc"  # periodic builds
    TRIGGER = "trigger_request"  # downstream project triggers


PATCH_REQUESTERS = frozenset(
    {Requester.PATCH.value, Requester.GITHUB_PR.value, Requester.GITHUB_MERGE.value}
)
GITHUB_MERGE_REQUESTER = Requester.GITHUB_MERGE.value


def is_patch_requester(requester: str) -> bool:
    return requester in PATCH_REQUESTERS


def is_github_merge_queue_requester(requester: str) -> bool:
    return requester == GITHUB_MERGE_REQUESTER


def is_mainline_requester(requester: str) -> bool:
    return requester in (Requester.REPOTRACKER.value, Requester.AD_HOC.value,
                         Requester.TRIGGER.value)


#: tasks above this priority lead the cmp-based planner's queue
MAX_TASK_PRIORITY = 100

#: sort-value boost of a unit holding a merge-queue task
COMMIT_QUEUE_PRIORITY_BOOST = 200

#: an undispatched task activated longer ago than this is unscheduled
UNDERWATER_UNSCHEDULE_THRESHOLD_S = 7 * 24 * 3600


STEPBACK_TASK_ACTIVATOR = "stepback-activator"

#: target queue turnaround per host, seconds
MAX_DURATION_PER_DISTRO_HOST_S = 30 * 60

#: expected duration of a task with no runtime history, seconds
DEFAULT_TASK_DURATION_S = 10 * 60

#: global cap on in-flight intent hosts
MAX_INTENT_HOSTS_IN_FLIGHT = 5000

#: per-task time in queue is clamped here before the f32 unit sums
MAX_TASK_TIME_IN_QUEUE_S = 14 * 24 * 3600

#: suffix of a distro id's secondary-queue alias row
ALIAS_SUFFIX = "::alias"


class PlannerVersion(str, enum.Enum):
    TUNABLE = "tunable"
    TPU = "tpu"
    CMP_BASED = "cmpbased"


class DispatcherVersion(str, enum.Enum):
    REVISED_WITH_DEPENDENCIES = "revised-with-dependencies"


class FinderVersion(str, enum.Enum):
    LEGACY = "legacy"
    PARALLEL = "parallel"
    PIPELINE = "pipeline"
    ALTERNATE = "alternate"


class OverallocatedRule(str, enum.Enum):
    DEFAULT = ""
    TERMINATE = "terminate-hosts-when-overallocated"
    IGNORE = "no-terminations-when-overallocated"


class RoundingRule(str, enum.Enum):
    DEFAULT = ""
    DOWN = "round-down"
    UP = "round-up"


class FeedbackRule(str, enum.Enum):
    DEFAULT = ""
    WAITS_OVER_THRESH = "waits-over-thresh"
    NO_FEEDBACK = "no-feedback"


class Provider(str, enum.Enum):
    EC2_FLEET = "ec2-fleet"
    EC2_ONDEMAND = "ec2-ondemand"
    DOCKER = "docker"
    STATIC = "static"
    MOCK = "mock"
    DOCKER_MOCK = "docker-mock"


#: providers whose hosts are spawned and terminated on demand
EPHEMERAL_PROVIDERS = frozenset(
    {
        Provider.EC2_FLEET.value,
        Provider.EC2_ONDEMAND.value,
        Provider.DOCKER.value,
        Provider.MOCK.value,
        Provider.DOCKER_MOCK.value,
    }
)
