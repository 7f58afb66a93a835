"""User-data generation for self-provisioning hosts.

A copy of ``evergreen_tpu/cloud/userdata.py`` (reference cloud/userdata/
directives.go, options.go, closing_tag.go + cloud/user_data.go): a host
whose distro bootstraps via ``user-data`` receives a script at spawn time
that fetches the agent, writes its host credential, runs the distro
setup script and phones home. Custom user data from the provider
settings merges with the provisioning part by directive type, closing
tags and the cloud-init multipart form. The rendered bytes are the JAX
package's, the on-host agent command (``python -m evergreen_tpu
agent-monitor``) included: the agent that runs on a host is not part of
the port.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

# Directive markers that determine the user-data type (reference
# cloud/userdata/directives.go:14-23).
SHELL_SCRIPT = "#!"
INCLUDE = "#include"
CLOUD_CONFIG = "#cloud-config"
UPSTART_JOB = "#upstart-job"
CLOUD_BOOTHOOK = "#cloud-boothook"
PART_HANDLER = "#part-handler"
POWERSHELL_SCRIPT = "<powershell>"
BATCH_SCRIPT = "<script>"

DIRECTIVES = (
    SHELL_SCRIPT,
    INCLUDE,
    CLOUD_CONFIG,
    UPSTART_JOB,
    CLOUD_BOOTHOOK,
    PART_HANDLER,
    POWERSHELL_SCRIPT,
    BATCH_SCRIPT,
)

# MIME content type per directive (directives.go:39-55); consumed by the
# multipart merge when custom + provisioning parts coexist.
CONTENT_TYPES = {
    SHELL_SCRIPT: "text/x-shellscript",
    INCLUDE: "text/x-include-url",
    CLOUD_CONFIG: "text/cloud-config",
    UPSTART_JOB: "text/upstart-job",
    CLOUD_BOOTHOOK: "text/cloud-boothook",
    PART_HANDLER: "text/part-handler",
    POWERSHELL_SCRIPT: "text/x-shellscript",
    BATCH_SCRIPT: "text/x-shellscript",
}

# Windows directives must be closed (closing_tag.go).
CLOSING_TAGS = {
    POWERSHELL_SCRIPT: "</powershell>",
    BATCH_SCRIPT: "</script>",
}

# Only Windows script types support <persist> (options.go:40-41).
_CAN_PERSIST = (POWERSHELL_SCRIPT, BATCH_SCRIPT)


class UserDataError(ValueError):
    pass


@dataclasses.dataclass
class UserData:
    """One user-data part (reference userdata.Options, options.go:9-21)."""

    directive: str
    content: str
    persist: bool = False

    def validate(self) -> None:
        if not self.directive:
            raise UserDataError("user data is missing directive")
        if not any(self.directive.startswith(d) for d in DIRECTIVES):
            raise UserDataError(f"directive {self.directive!r} is invalid")
        if self.persist and not self.can_persist():
            raise UserDataError(
                f"cannot specify persisted user data with directive "
                f"{self.directive!r}"
            )

    def can_persist(self) -> bool:
        return any(self.directive.startswith(d) for d in _CAN_PERSIST)

    def closing_tag(self) -> str:
        for d, tag in CLOSING_TAGS.items():
            if self.directive.startswith(d):
                return tag
        return ""

    def content_type(self) -> str:
        for d, ct in CONTENT_TYPES.items():
            if self.directive.startswith(d):
                return ct
        raise UserDataError(f"unrecognized directive {self.directive!r}")

    def render(self) -> str:
        """Directive line + content (+ persist tag and closing tag on
        Windows), the on-wire shape handed to the cloud API."""
        self.validate()
        lines = [self.directive, self.content.rstrip("\n")]
        if self.persist:
            lines.append("<persist>true</persist>")
        tag = self.closing_tag()
        if tag:
            lines.append(tag)
        return "\n".join(lines) + "\n"


def parse(raw: str) -> UserData:
    """Split raw user data into (directive, content), tolerating a missing
    trailing closing tag the way the reference's parser does."""
    raw = raw.lstrip()
    for d in DIRECTIVES:
        if raw.startswith(d):
            rest = raw[len(d):]
            # the shell directive keeps its interpreter suffix ("#!/bin/sh")
            if d == SHELL_SCRIPT:
                nl = raw.find("\n")
                directive = raw if nl < 0 else raw[:nl]
                rest = "" if nl < 0 else raw[nl + 1:]
                u = UserData(directive=directive, content=rest)
            else:
                u = UserData(directive=d, content=rest.lstrip("\n"))
            tag = u.closing_tag()
            if tag and u.content.rstrip().endswith(tag):
                u.content = u.content.rstrip()[: -len(tag)].rstrip("\n")
            return u
    raise UserDataError(f"user data has no recognized directive: {raw[:40]!r}")


def _is_windows(arch: str) -> bool:
    return arch.startswith("windows")


def provisioning_script(
    distro, host, api_url: str, *, windows: Optional[bool] = None
) -> UserData:
    """The framework-owned provisioning part: fetch the agent, persist the
    host credential, run the distro setup script, start the agent monitor,
    and phone home. Reference: cloud/user_data.go makeUserData +
    units/provisioning_agent_deploy.go:246-268 (curl + setup + start),
    with the jasper bootstrap replaced by the agent monitor subprocess
    supervisor — the TPU-native host runtime.
    """
    windows = _is_windows(distro.arch) if windows is None else windows
    work = distro.work_dir or "/data/evg"
    done_url = f"{api_url}/rest/v2/hosts/{host.id}/agent/provisioning_done"
    if windows:
        body_lines = [
            f"New-Item -ItemType Directory -Force -Path {work}",
            f"Set-Content -Path {work}\\host_secret -Value '{host.secret}'",
        ]
        if distro.setup:
            body_lines.append(distro.setup)
        body_lines += [
            f"Start-Process python -ArgumentList '-m','evergreen_tpu',"
            f"'agent-monitor','--host-id','{host.id}',"
            f"'--api-server','{api_url}','--working-dir','{work}'",
            f"Invoke-WebRequest -Method POST -Uri {done_url} "
            f"-Headers @{{'Host-Id'='{host.id}';'Host-Secret'='{host.secret}'}}",
        ]
        return UserData(
            directive=POWERSHELL_SCRIPT,
            content="\n".join(body_lines),
            persist=True,
        )
    body_lines = [
        "set -o errexit",
        f"mkdir -p {work}",
        f"umask 077 && echo '{host.secret}' > {work}/host_secret",
    ]
    if distro.setup:
        body_lines.append(distro.setup)
    body_lines += [
        f"nohup python -m evergreen_tpu agent-monitor "
        f"--host-id {host.id} --api-server {api_url} "
        f"--host-secret {host.secret} --working-dir {work} "
        f">{work}/agent-monitor.log 2>&1 &",
        f"curl -fsS -X POST -H 'Host-Id: {host.id}' "
        f"-H 'Host-Secret: {host.secret}' {done_url}",
    ]
    return UserData(directive="#!/bin/sh", content="\n".join(body_lines))


_MIME_BOUNDARY = "==evergreen-userdata-boundary=="


def merge_parts(parts: List[UserData]) -> str:
    """Merge provisioning + custom user data. One part renders directly;
    shell parts concatenate (custom first, matching the reference's
    ordering so user setup runs before the agent starts); mixed directive
    types fall back to a cloud-init MIME multipart document (reference
    cloud/user_data.go multipart assembly)."""
    parts = [p for p in parts if p and p.content.strip()]
    if not parts:
        raise UserDataError("no user data parts to merge")
    for p in parts:
        p.validate()
    if len(parts) == 1:
        return parts[0].render()

    def family(p: UserData) -> str:
        for d in (SHELL_SCRIPT, POWERSHELL_SCRIPT, BATCH_SCRIPT):
            if p.directive.startswith(d):
                return d
        return p.directive

    fams = {family(p) for p in parts}
    if len(fams) == 1 and fams <= {SHELL_SCRIPT, POWERSHELL_SCRIPT, BATCH_SCRIPT}:
        # same-interpreter scripts: keep the first directive line, join
        # bodies (a #! body cannot ride a <powershell> directive or vice
        # versa — mixed interpreters fall through to MIME multipart)
        merged_body = "\n".join(p.content.rstrip("\n") for p in parts)
        merged = dataclasses.replace(
            parts[0], content=merged_body, persist=any(p.persist for p in parts)
        )
        return merged.render()
    out = [
        'Content-Type: multipart/mixed; boundary="%s"' % _MIME_BOUNDARY,
        "MIME-Version: 1.0",
        "",
    ]
    for p in parts:
        out += [
            f"--{_MIME_BOUNDARY}",
            f"Content-Type: {p.content_type()}",
            "",
            p.render().rstrip("\n"),
            "",
        ]
    out.append(f"--{_MIME_BOUNDARY}--")
    return "\n".join(out) + "\n"


def for_host(
    distro, host, api_url: str,
    authorized_keys: Optional[List[str]] = None,
) -> str:
    """Full user-data payload for a spawning host: custom distro user data
    (provider_settings["user_data"]) merged with the provisioning script,
    plus the owner's SSH public keys for spawn hosts (reference: spawn
    hosts write the user's PubKeys into authorized_keys,
    cloud/spawn.go)."""
    parts: List[UserData] = []
    custom = (distro.provider_settings or {}).get("user_data", "")
    if custom:
        parts.append(parse(custom))
    if authorized_keys and not _is_windows(distro.arch):
        # quoted-delimiter heredoc: nothing in the key text is expanded or
        # interpreted; model-level validation (models/user.py) already
        # rejects newlines/quotes, so a key line can never terminate the
        # heredoc early — defense in depth against shell injection
        delim = "EVG_AUTHORIZED_KEYS_EOF_7f3a"
        key_block = "\n".join(
            k for k in authorized_keys if delim not in k and "\n" not in k
        )
        parts.append(
            UserData(
                directive="#!/bin/sh",
                content=(
                    f"mkdir -p ~{distro.user}/.ssh\n"
                    f"cat >> ~{distro.user}/.ssh/authorized_keys "
                    f"<<'{delim}'\n{key_block}\n{delim}"
                ),
            )
        )
    parts.append(provisioning_script(distro, host, api_url))
    return merge_parts(parts)
